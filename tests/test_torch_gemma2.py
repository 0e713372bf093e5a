"""gemma2-2b through the whole slice: the port's ``AmpereTrainer`` against
``repro.core.uit.AmpereTrainer``, and the port's launcher against its own
trainer.

The gemma2-2b smoke config keeps every branch its full-width path reaches:
a sliding window (8) on the even layers, global attention on the odd ones,
attention softcap 50, final softcap 30 (the device's auxiliary head and
the server's head both go through the softcapped xent), GeGLU, post-block
norms and the scaled, tied embedding.  SEQ 32 is past the window, so the
local layers mask.  The federation, optimizer, data and phases are
``tests/test_torch_ampere.py``'s (4 clients, cohort 2, H 2, 2 device
rounds, 2 server epochs, from the JAX trainer's initial states converted
through numpy), with the same tolerances: losses within 1e-5 relative,
next-token accuracy within 1e-2 absolute.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_ampere as A
import torch_lm_path as L
from repro.configs import registry
from repro.core import evaluate as j_evaluate
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.core import evaluate, losses
from repro_torch.interop import from_numpy_tree
from repro_torch.models import build_model

ARCH = "gemma2-2b"


def test_smoke_config_has_local_and_global_layers():
    cfg = t_registry.get_smoke_config(ARCH)
    windows = [cfg.layer_kind(i)[1] for i in range(cfg.num_layers)]
    assert windows == [cfg.sliding_window, 0] * (cfg.num_layers // 2)
    assert 0 < cfg.sliding_window < A.SEQ
    assert cfg.attn_softcap == 50.0 and cfg.final_softcap == 30.0


@pytest.mark.parametrize("phase,key", [("device", "round"),
                                       ("server", "epoch")])
def test_history_matches_jax_trainer(phase, key):
    A._check_history(ARCH, phase, key)


def test_launcher_run_training_matches_trainer():
    """``launch.train.run_training`` on the smoke config on the CPU: the
    history of the trainer driven phase by phase from the launcher's own
    init, key for key."""
    L.check_launcher_matches_trainer(ARCH)


def test_served_merged_params_match_merged_eval():
    """The launcher's merged params served as ``chip_smoke.py`` serves
    them (``served_model``: the merged config, its tied head untied, as
    the trainer evaluates it) give the merged eval's loss; under the
    published tied config the output head is the device's embedding, not
    the server's trained head, and the loss differs."""
    L.check_served_merged_params(ARCH)


@pytest.mark.parametrize("arch", [ARCH, "qwen3-1.7b"])
@pytest.mark.parametrize("chunk", [7, None])
def test_eval_step_matches_full_logits(arch, chunk, monkeypatch):
    """``evaluate.eval_step`` runs the head over at most
    ``MAX_EVAL_LOGITS`` logits at a time (gemma2-2b's 4 x 8192 x 256000
    would not fit the card): the loss and accuracy of the port's full
    (B, S, V) logits and of ``repro.core.evaluate``'s eval step on the
    same params (the JAX init converted through numpy), in one chunk and
    in chunks of 7 positions (ragged at the end)."""
    j_cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                dtype="float32")
    j_model = j_build(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(t_registry.get_smoke_config(arch),
                              dtype="float32")
    model = build_model(cfg)
    params = from_numpy_tree(jax.tree.map(np.asarray, j_params))
    np_tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, A.SEQ)).astype(np.int32)
    tokens = torch.as_tensor(np_tokens)
    logits = model.apply(params, tokens, remat="none")["logits"]
    want_loss, _ = losses.lm_loss_from_logits(logits, tokens)
    want_acc = torch.mean((torch.argmax(logits[:, :-1], dim=-1)
                           == tokens[:, 1:].long()).float())
    ref_loss, ref_acc = j_evaluate.make_eval_step(j_model)(
        j_params, {"tokens": np_tokens})
    if chunk:
        monkeypatch.setattr(evaluate, "MAX_EVAL_LOGITS",
                            chunk * cfg.vocab_size)
    loss, acc = evaluate.eval_step(model, params, {"tokens": tokens})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert float(acc) == float(want_acc)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(ref_acc), atol=1e-2)
