"""Communication compression, as ``repro.runtime.compression`` (an option
beyond the paper, off by default): int8 activation payloads, which shrink
Ampere's one-shot activation transfer (the s^(act) term of Eq. 27) 4x
against fp32, with one absmax scale per row of the last axis.

The payload is quantized where it is stored, by the store's numpy
(``data.activation_store.ActivationStore.prepare_shard``, the reference's
arithmetic, so the stored bytes are identical); the server step
dequantizes each batch here.  The reference's top-k sparsification of
model updates (``topk_compress``) is called nowhere in either package,
so it is not ported.
"""

from __future__ import annotations


def dequantize_int8(q, scale):
    """int8 ``q`` times its fp32 per-row ``scale`` (trailing dim 1)."""
    return q.float() * scale
