"""Serving launcher: batched prefill and greedy decode over the merged
(device + server) model, the inference side of an Ampere-trained system,
as ``repro.launch.serve``.

``LMServer`` fills fp32 KV (and Mamba) caches for a batch of prompts in
one prefill call, then decodes one greedy token a call, under
``torch.inference_mode``.  The command line serves a smoke config from a
random init and prints one JSON line (the reference's keys).  Runs on
CUDA unless ``--device cpu``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.core import steps
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.models import build_model
from repro_torch.models import transformer as T


class LMServer:
    """Minimal batched serving loop (greedy decoding)."""

    def __init__(self, model, params, run_cfg=None, max_len: int = 256,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = model.cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_len = max_len
        run_cfg = run_cfg or RunConfig()
        self._prefill = steps.make_prefill_step(model, run_cfg)
        self._decode = steps.make_decode_step(model, run_cfg)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, new_tokens: int = 32):
        """prompts: (B, S0) int.  Returns (B, new_tokens) int32."""
        B, S0 = prompts.shape
        caches = T.init_caches(self.cfg, B, self.max_len,
                               kv_dtype="float32", device=self.device)
        logits, caches = self._prefill(
            self.params, torch.as_tensor(prompts, device=self.device),
            caches)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok]
        for index in range(S0, S0 + new_tokens - 1):
            tok, _, caches = self._decode(self.params, caches, tok, index)
            tok = tok[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = registry.get_smoke_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(args.seed))
    server = LMServer(model, params,
                      max_len=args.prompt_len + args.new_tokens + 1,
                      device=args.device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    # real serving throughput: generate returns the tokens on the host
    t0 = time.perf_counter()
    out = server.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "arch": args.arch, "batch": args.batch,
        "generated_shape": list(out.shape),
        "tokens_per_s": args.batch * args.new_tokens / dt,
        "sample": out[0][:8].tolist(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
