"""The registered LMs that only the reference's launcher had trained:
``qwen1.5-4b`` (MHA with a qkv bias, SwiGLU, untied), ``qwen2-vl-72b``
(M-RoPE over three position sections), ``mistral-large-123b`` (GQA, a
32768 vocab) and ``musicgen-large`` (MHA, a plain GELU MLP, untied), each
through the port's ``AmpereTrainer`` against
``repro.core.uit.AmpereTrainer`` on its smoke config.

The federation, optimizer, data and phases are
``tests/test_torch_ampere.py``'s (4 clients, cohort 2, H 2, 2 device
rounds, 2 server epochs, from the JAX trainer's initial states converted
through numpy), with the same tolerances: losses within 1e-5 relative,
next-token accuracy within 1e-2 absolute.  musicgen-large's launcher and
serving checks are ``tests/test_torch_musicgen.py``'s.
"""

import pytest

import test_torch_ampere as A
import torch_experiment_parity as P
from repro_torch.configs import registry as t_registry

ARCHS = ("qwen1.5-4b", "qwen2-vl-72b", "mistral-large-123b",
         "musicgen-large")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def test_archs_take_the_branches_named():
    """Each smoke config reaches the branch it is here for."""
    qwen15, vl, mistral, _ = (t_registry.get_smoke_config(a) for a in ARCHS)
    assert qwen15.qkv_bias and not qwen15.tie_embeddings
    assert qwen15.num_kv_heads == qwen15.num_heads
    assert vl.mrope_sections and sum(vl.mrope_sections) == vl.head_dim // 2
    assert mistral.num_kv_heads < mistral.num_heads


@pytest.mark.parametrize("phase,key", [("device", "round"),
                                       ("server", "epoch")])
@pytest.mark.parametrize("arch", ARCHS)
def test_history_matches_jax_trainer(arch, phase, key):
    A._check_history(arch, phase, key)
