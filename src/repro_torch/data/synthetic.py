"""Synthetic, *learnable* datasets (offline container — no downloads).

Vision: class-template images — each class is a fixed random spatial
pattern; samples are template + elastic noise.  CNNs/ViTs reach high
accuracy quickly, and Dirichlet label skew reproduces the paper's non-IID
behaviour qualitatively.

LM: domain-mixture bigram corpus — each "class" (domain) is a distinct
random bigram transition matrix over the vocabulary; a sequence is sampled
from its domain's Markov chain.  An LM that learns per-domain bigram
statistics drives the loss well below the unigram entropy, so both the
device block (with aux head) and the server block show real learning
curves, and domain labels give the Dirichlet partitioner something to
skew.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Dataset:
    """In-memory dataset: dict of aligned numpy arrays + class labels."""
    arrays: dict           # e.g. {"images": ..., "labels": ...} / {"tokens": ...}
    labels: np.ndarray     # partitioning key (class / domain)

    def __len__(self):
        return len(self.labels)

    def subset(self, idx):
        return Dataset({k: v[idx] for k, v in self.arrays.items()},
                       self.labels[idx])


def make_vision_dataset(n: int, num_classes: int = 10, img_size: int = 32,
                        channels: int = 3, noise: float = 0.6,
                        seed: int = 0, template_seed: int = 1234) -> Dataset:
    # class templates come from template_seed so train/test splits share them
    trng = np.random.default_rng(template_seed)
    templates = trng.normal(0, 1, (num_classes, img_size, img_size, channels))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    shifts = rng.integers(-2, 3, (n, 2))
    imgs = templates[labels]
    # per-sample random translation (cheap augmentation-like variation)
    imgs = np.stack([np.roll(im, tuple(s), axis=(0, 1))
                     for im, s in zip(imgs, shifts)])
    imgs = imgs + noise * rng.normal(0, 1, imgs.shape)
    return Dataset({"images": imgs.astype(np.float32),
                    "labels": labels.astype(np.int32)},
                   labels.astype(np.int64))


def make_lm_dataset(n: int, seq_len: int = 64, vocab: int = 257,
                    num_domains: int = 10, temp: float = 1.2,
                    seed: int = 0, template_seed: int = 1234) -> Dataset:
    # domain bigram matrices come from template_seed: shared across splits
    trng = np.random.default_rng(template_seed)
    trans = trng.gumbel(0, 1, (num_domains, vocab, vocab)) * temp
    trans = np.exp(trans - trans.max(-1, keepdims=True))
    trans /= trans.sum(-1, keepdims=True)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_domains, n)
    toks = np.empty((n, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n)
    # vectorized Markov sampling over all sequences at once
    u = rng.random((n, seq_len))
    for t in range(1, seq_len):
        rows = trans[labels, toks[:, t - 1]]        # (n, vocab)
        cdf = np.cumsum(rows, axis=1)
        toks[:, t] = (u[:, t, None] > cdf).sum(1).clip(0, vocab - 1)
    return Dataset({"tokens": toks}, labels.astype(np.int64))


def make_dataset_for_model(model, n: int, seq_len: int = 64, seed: int = 0,
                           num_classes: Optional[int] = None) -> Dataset:
    if model.kind == "lm":
        return make_lm_dataset(n, seq_len=seq_len,
                               vocab=model.cfg.vocab_size,
                               num_domains=num_classes or 10, seed=seed)
    return make_vision_dataset(n, num_classes=model.cfg.num_classes,
                               img_size=model.cfg.img_size, seed=seed)
