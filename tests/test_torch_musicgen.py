"""musicgen-large through the whole slice: its config's branches, and the
port's launcher against its own trainer and its served merged params
against the merged eval.  Its histories against
``repro.core.uit.AmpereTrainer`` are ``tests/test_torch_lm_archs.py``'s.

The musicgen-large smoke config keeps every branch its full-width path
reaches: multi-head attention (kv heads = heads, one query a kv head), a
plain two-layer GELU MLP (``wi``, ``wo``; no gate), RoPE, no softcap or
window, and an untied head over a small vocabulary.  The federation,
optimizer, data and phases are ``tests/test_torch_ampere.py``'s.
"""

import pytest
import torch

import torch_experiment_parity as P
import torch_lm_path as L
from repro_torch.configs import registry as t_registry
from repro_torch.models import build_model

ARCH = "musicgen-large"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


@pytest.mark.parametrize("smoke", [True, False])
def test_config_is_mha_with_a_plain_gelu_mlp(smoke):
    """The smoke config and the published one: every kv head serves one
    query head, and each layer's MLP is ``wi`` then GELU then ``wo``, with
    no gate; the head is untied."""
    get = t_registry.get_smoke_config if smoke else t_registry.get_config
    cfg = get(ARCH)
    assert cfg.num_kv_heads == cfg.num_heads
    assert cfg.mlp_activation == "gelu" and not cfg.tie_embeddings
    assert cfg.sliding_window == 0 and cfg.attn_softcap == 0.0
    assert cfg.final_softcap == 0.0
    if not smoke:
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
                cfg.d_ff, cfg.vocab_size) == (48, 2048, 32, 64, 8192, 2048)
        return
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    blocks = params["blocks"]
    assert len(blocks) == 1
    (block,) = blocks.values()
    assert set(block["mlp"]) == {"wi", "wo"}
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    assert tuple(block["mlp"]["wi"]["w"].shape) == (L, D, F)
    assert tuple(block["mlp"]["wo"]["w"].shape) == (L, F, D)
    kv = cfg.num_kv_heads * cfg.head_dim
    assert tuple(block["attn"]["wk"]["w"].shape) == (L, D, kv)
    assert tuple(block["attn"]["wq"]["w"].shape) == (L, D, kv)
    assert tuple(params["head"]["w"].shape) == (D, cfg.vocab_size)


def test_launcher_run_training_matches_trainer():
    """``launch.train.run_training`` on the smoke config on the CPU: the
    history of the trainer driven phase by phase from the launcher's own
    init, key for key."""
    L.check_launcher_matches_trainer(ARCH)


def test_served_merged_params_match_merged_eval():
    """The launcher's merged params served as ``chip_smoke.py`` serves
    them (``served_model``: the trainer's merged config) give the merged
    eval's loss; the head is untied, so the published config serves the
    same model."""
    L.check_served_merged_params(ARCH)
