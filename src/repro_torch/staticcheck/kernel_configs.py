"""The config matrix the kernel analyzer runs through the host build.

Each config calls one ``rt_*`` entry point of ``csrc/*.cu`` with one
concrete shape, as the port's wrappers (``repro_torch/kernels/*/kernel.py``)
call it.  Two tiers:

- ``record``: the shapes the port launches (the main paths' server steps,
  the serving prefill, the other published configs' heads), run in
  record-only mode with fake 256-B aligned pointers: no kernel body runs,
  so full widths cost nothing.  ``expect["launches"]`` lists every launch
  the call makes, (kernel, grid, threads, dynamic shared memory, the
  attribute set before it, -1 for none), derived by hand from the tile
  constants and formulas of the ``.cu`` (the ``_*_tiles`` and ``*_smem``
  functions below restate them); ``expect["guarded"]`` names the pointers
  whose misalignment the entry must refuse (``tc_aligned`` and xent's bf16
  h check).
- ``execute``: small shapes, one per branch of the emulated kernel tests'
  matrices (causal, window, softcap, ragged ``kv_len``, rows with no valid
  key, G > 1, both dtypes, fused and split backward, several vocabulary
  splits and token chunks, several SSD head groups), run for real twice:
  the analyzer's turn order, alignment and write-before-read checks read
  them.  ``expect["accumulators"]`` names the buffers the caller zeroes and
  the kernels add into (the fused backward's dQ and turn counters), which
  alone are not pre-filled with NaN; ``expect["turn_distance"]`` the
  blocks between consecutive holders of a dQ turn counter.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

XENT_PATH = "src/repro_torch/csrc/xent.cu"
FA_PATH = "src/repro_torch/csrc/flash_attention.cu"
SSD_PATH = "src/repro_torch/csrc/ssd_chunk.cu"
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4}
DTYPE_CODE = {"float32": 0, "bfloat16": 1}
H100_SMS = 132     # the split count the xent wrapper asks for on an H100


class Ptr(str):
    """An argument that is the address of the named buffer."""


@dataclasses.dataclass(frozen=True)
class Buf:
    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    role: str = "in"       # in | out | acc | scratch
    fill: str = "normal"   # inputs: normal | labels<V> | dt | acum

    @property
    def nbytes(self) -> int:
        n = ITEMSIZE[self.dtype]
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    name: str
    tier: str                       # record | execute
    entry: str                      # the rt_* entry point called
    buffers: Tuple[Buf, ...]
    args: tuple                     # Ptr names, None (null) and scalars
    expect: dict = dataclasses.field(default_factory=dict, hash=False)

    @property
    def path(self) -> str:
        return {"flash": FA_PATH, "xent": XENT_PATH,
                "ssd": SSD_PATH}.get(self.entry.split("_")[1], "")


def _cdiv(a, b):
    return -(-a // b)


# --- flash attention: csrc/flash_attention.cu -------------------------------

FA_THREADS = 256   # rt::kThreads: fa_split_kernel


def fa_planes(dtype):
    """planes_of<T>: kQkPlanes (3) for fp32 q, k, v, 1 for bf16."""
    return 3 if dtype == "float32" else 1


def fa_fwd_tiles(hd, np_):
    """TcFwd<HD, NP>: (BQ, BK, THREADS, SMEM)."""
    nv = 3 if np_ > 1 else 1
    nsplit = 2 if hd > 128 else 1
    bq = 128 if np_ > 1 and hd <= 128 else 64
    bk = (32 if hd > 128 else 64) // (2 if np_ > 1 else 1)
    smem = (np_ * bq + 2 * (np_ + nv) * bk) * (hd + 8) * 2
    return bq, bk, 32 * (bq // 16) * nsplit, smem


def fa_dq_tiles(hd, np_):
    """TcDq<HD, NP>: (BQ, BK, THREADS, SMEM)."""
    nv = 2 if np_ > 1 else 1
    nsplit = 2 if hd > 128 else 1
    bq = (32 if hd > 128 else 128) if np_ > 1 else 64
    bk = 16 if np_ > 1 else (32 if hd > 128 else 64)
    smem = ((np_ + nv) * bq + 2 * (np_ + nv) * bk) * (hd + 8) * 2
    return bq, bk, 32 * (bq // 16) * nsplit, smem


def fa_bwd_tiles(hd, np_, dout_f32, dq):
    """TcBwd<HD, NP> and its smem<TO, kDQ>(): (BQ, BK, THREADS, SMEM)."""
    nv = 2 if np_ > 1 else 1
    nsplit = 2 if hd > 128 else 1
    small = np_ > 1 and hd > 128
    bk = 32 if small else 64
    bq = 16 if small else (32 if hd > 64 else 64)
    ld, lds = hd + 8, bq + 8
    bf16 = ((np_ + nv) * bk * ld + 2 * np_ * bq * ld + 2 * bq * ld
            + (2 * bk * lds if dq else 0))
    f32 = (bq * hd if dout_f32 else 0) + 4 * bq
    return bq, bk, 32 * (bk // 16) * nsplit, bf16 * 2 + f32 * 4


def fa_plane_elems(nq, nkv):
    """plane_elems: kQkPlanes (nq + nkv) + kVPlanes nkv."""
    return 3 * (nq + nkv) + 3 * nkv


def _fa_split_launch(nq, nkv):
    blocks = _cdiv(max(nq, nkv) // 4, FA_THREADS)
    return ("fa_split_kernel", (blocks, 3, 1), FA_THREADS, 0, -1)


def flash(name, tier, kind, B, Hkv, G, Sq, hd, dtype, *, Skv=None,
          causal=True, window=0, softcap=0.0, kv_len=None):
    """One call of rt_flash_fwd (kind "fwd"), rt_flash_bwd ("fused"),
    rt_flash_bwd_dq ("dq") or rt_flash_bwd_dkv ("dkv") as the wrapper makes
    it: q (B Hkv G, Sq, hd) kv-major, k and v (B Hkv, Skv, hd)."""
    Skv = Sq if Skv is None else Skv
    kv_len = Skv if kv_len is None else kv_len
    BKV = B * Hkv
    BH = BKV * G
    np_ = fa_planes(dtype)
    nq, nkv = BH * Sq * hd, BKV * Skv * hd
    qkv = (Buf("q", (BH, Sq, hd), dtype), Buf("k", (BKV, Skv, hd), dtype),
           Buf("v", (BKV, Skv, hd), dtype))
    planes = (Buf("planes", (fa_plane_elems(nq, nkv),), "bfloat16",
                  "scratch"),) if np_ > 1 else ()
    planes_arg = Ptr("planes") if np_ > 1 else None
    scalars = (Sq, Skv, hd, G, int(causal), window, float(softcap),
               float(hd ** -0.5), kv_len, None)
    launches = [_fa_split_launch(nq, nkv)] if np_ > 1 else []
    guarded = ["q", "k", "v"] + (["planes"] if np_ > 1 else [])
    expect = {}
    if kind == "fwd":
        bq, _, threads, smem = fa_fwd_tiles(hd, np_)
        launches.append((f"fa_fwd_tc_kernel<{hd}, {np_}>",
                         (BH, _cdiv(Sq, bq), 1), threads, smem, smem))
        bufs = qkv + planes + (Buf("o", (BH, Sq, hd), role="out"),
                               Buf("lse", (BH, Sq), role="out"))
        args = (Ptr("q"), Ptr("k"), Ptr("v"), planes_arg, Ptr("o"),
                Ptr("lse"), DTYPE_CODE[dtype], BH) + scalars
        entry = "rt_flash_fwd"
    else:
        dout_dt = "float32" if kind == "fused" else dtype
        ops = (Buf("dout", (BH, Sq, hd), dout_dt), Buf("lse", (BH, Sq)),
               Buf("delta", (BH, Sq)))
        guarded.append("dout")
        head = (Ptr("q"), Ptr("k"), Ptr("v"), planes_arg, Ptr("dout"),
                Ptr("lse"), Ptr("delta"))
        tail = (DTYPE_CODE[dtype], BH) + scalars
        dkv = (Buf("dk", (BKV, Skv, hd), role="out"),
               Buf("dv", (BKV, Skv, hd), role="out"))
        if kind == "dq":
            bq, _, threads, smem = fa_dq_tiles(hd, np_)
            launches.append((f"fa_bwd_dq_tc_kernel<{hd}, {np_}>",
                             (BH, _cdiv(Sq, bq), 1), threads, smem, smem))
            bufs = qkv + planes + ops + (Buf("dq", (BH, Sq, hd),
                                             role="out"),)
            args = head + (Ptr("dq"),) + tail
            entry = "rt_flash_bwd_dq"
        else:
            fused = kind == "fused"
            to_f32 = fused or np_ > 1
            bq, bk, threads, smem = fa_bwd_tiles(hd, np_, to_f32, fused)
            to = "float" if to_f32 else "__nv_bfloat16"
            launches.append((f"fa_bwd_tc_kernel<{hd}, {to}, "
                             f"{'true' if fused else 'false'}, {np_}>",
                             (BKV, _cdiv(Skv, bk), 1), threads, smem, smem))
            if fused:
                n_turns = BH * _cdiv(Sq, bq)
                bufs = qkv + planes + ops + (
                    Buf("dq", (BH, Sq, hd), role="acc"),) + dkv + (
                    Buf("turns", (n_turns,), "int32", "acc"),)
                args = head + (Ptr("dq"), Ptr("dk"), Ptr("dv"),
                               Ptr("turns"), n_turns) + tail
                entry = "rt_flash_bwd"
                expect["accumulators"] = ("dq", "turns")
                # the kv tile is blockIdx.y: consecutive kv tiles of one
                # q tile sit a row of grid.x = B Hkv blocks apart
                expect["turn_distance"] = BKV if _cdiv(Skv, bk) > 1 \
                    else None
            else:
                bufs = qkv + planes + ops + dkv
                args = head + (Ptr("dk"), Ptr("dv")) + tail
                entry = "rt_flash_bwd_dkv"
    expect.update(launches=tuple(launches), guarded=tuple(guarded))
    return KernelConfig(name, tier, entry, bufs, args, expect)


# --- cross-entropy: csrc/xent.cu --------------------------------------------

TBM = TBN = 128
TC_CHUNK, STAGE_BYTES = 32, 4 * 2 ** 30   # xent/kernel.py's chunk rule
XENT_THREADS = 256
SMEM_PER_SM, SMEM_PER_CTA, CTAS_PER_SM = 228 * 1024, 1024, 2
TILE_RK, TILE_KR = 128 * 40, 32 * 136   # [row][k] and [k][row] bf16 tiles


def xent_nsplit(T, V, sms=H100_SMS):
    """xent_tc_nsplit_impl: vocabulary splits of a grid over T tokens."""
    nt, nv = _cdiv(T, TBM), _cdiv(V, TBN)
    slots = max(1, sms) * CTAS_PER_SM
    n0 = max(1, min(nv, _cdiv(4 * slots, nt)))
    best, best_eff = n0, -1.0
    for n in range(n0, min(nv, 2 * n0) + 1):
        per = _cdiv(nv, n)
        used = _cdiv(nv, per)
        waves = _cdiv(nt * used, slots)
        eff = nt * nv / (waves * slots * per)
        if eff > best_eff + 1e-9:
            best_eff, best = eff, used
    return best


def _stage_bytes(akm, bkn, alo, blo):
    """tc_stage_bytes<kAKM, kBKN, kALo, kBLo>."""
    ea = TILE_KR if akm else TILE_RK
    eb = TILE_KR if bkn else TILE_RK
    return ((1 + alo) * ea + (1 + blo) * eb) * 2


def _stages(stage, static):
    """tc_stages: three where two CTAs fit an SM, else two."""
    fits = CTAS_PER_SM * (3 * stage + static + SMEM_PER_CTA) <= SMEM_PER_SM
    return 3 if fits else 2


def xent_logits_smem(hlo, wlo, dlogits):
    stage = _stage_bytes(False, False, hlo, wlo)
    static = (2 * TBM + (1 if dlogits else 16) * XENT_THREADS) * 4
    return _stages(stage, static) * stage


def xent_gemm_smem(akm, alo, blo):
    stage = _stage_bytes(akm, True, alo, blo)
    return _stages(stage, 0) * stage


def _b(x):
    return "true" if x else "false"


def _xent_split_launches(T, D, V, hlo, wlo):
    Dp, Vp = _cdiv(D, 8) * 8, _cdiv(V, TBN) * TBN
    out = []
    if hlo:
        out.append(("xent_split_h_kernel",
                    (_cdiv(T * (Dp // 2), XENT_THREADS), 1, 1),
                    XENT_THREADS, 0, -1))
    tw = "float, true" if wlo else "__nv_bfloat16, false"
    out.append((f"xent_split_kernel<{tw}>", (Vp // 64, _cdiv(Dp, 64), 1),
                XENT_THREADS, 0, -1))
    return out


def _gemm_launch(akm, alo, blo, M, N):
    smem = xent_gemm_smem(akm, alo, blo)
    return (f"xent_tc_gemm_kernel<{_b(akm)}, {_b(alo)}, {_b(blo)}>",
            (_cdiv(N, TBN), _cdiv(M, TBM), 1), XENT_THREADS, smem, smem)


def xent(name, tier, backward, T, D, V, hdt="bfloat16", wdt="float32", *,
         tied=False, softcap=0.0, chunk=None):
    """One call of rt_xent_fwd_tc or rt_xent_bwd_tc as the wrapper makes
    it: h (T, D), w (D, V) (tied: a (V, D) embedding read through its
    transpose), the split scratch, and for the backward the dlogits
    staging of ``chunk`` rows (the wrapper's _tc_chunk by default)."""
    hlo, wlo = hdt == "float32", wdt == "float32"
    Dp, Vp = _cdiv(D, 8) * 8, _cdiv(V, TBN) * TBN
    w_shape, (sw_d, sw_v) = ((V, D), (1, D)) if tied else ((D, V), (V, 1))
    bufs = [Buf("h", (T, D), hdt), Buf("w", w_shape, wdt),
            Buf("labels", (T,), "int32", fill=f"labels{V}")]
    scratch = ([Buf("h_hi", (T, Dp), "bfloat16", "scratch"),
                Buf("h_lo", (T, Dp), "bfloat16", "scratch")] if hlo else [])
    scratch += [Buf("w_hi", (Vp, Dp), "bfloat16", "scratch")]
    scratch += ([Buf("w_lo", (Vp, Dp), "bfloat16", "scratch")] if wlo
                else [])
    planes = (Ptr("h_hi") if hlo else None, Ptr("h_lo") if hlo else None,
              Ptr("w_hi"), Ptr("w_lo") if wlo else None)
    launches = _xent_split_launches(T, D, V, hlo, wlo)
    codes = (DTYPE_CODE[hdt], DTYPE_CODE[wdt], T, D, V, sw_d, sw_v)
    if not backward:
        nsplit = xent_nsplit(T, V)
        bufs += [Buf("loss", (T,), role="out"), Buf("lse", (T,), role="out"),
                 Buf("part", (3, nsplit, T), role="scratch")] + scratch
        args = (Ptr("h"), Ptr("w"), Ptr("labels"), Ptr("loss"), Ptr("lse"),
                Ptr("part")) + planes + codes + (float(softcap), nsplit,
                                                 None)
        smem = xent_logits_smem(hlo, wlo, False)
        launches += [
            (f"xent_tc_logits_kernel<{_b(hlo)}, {_b(wlo)}, false>",
             (_cdiv(T, TBM), nsplit, 1), XENT_THREADS, smem, smem),
            ("xent_combine_kernel", (_cdiv(T, 256), 1, 1), 256, 0, -1)]
        entry = "rt_xent_fwd_tc"
    else:
        if chunk is None:
            rows = max(TC_CHUNK, STAGE_BYTES // (4 * Vp) // TC_CHUNK
                       * TC_CHUNK)
            chunk = min(rows, _cdiv(T, TC_CHUNK) * TC_CHUNK)
        dw_shape, (sdw_d, sdw_v) = (((V, D), (1, D)) if tied
                                    else ((D, V), (V, 1)))
        bufs += [Buf("lse", (T,)), Buf("g", (T,)),
                 Buf("dh", (T, D), role="out"),
                 Buf("dw", dw_shape, role="out")] + scratch + [
            Buf("st_hi", (chunk, Vp), "bfloat16", "scratch"),
            Buf("st_lo", (chunk, Vp), "bfloat16", "scratch")]
        args = (Ptr("h"), Ptr("w"), Ptr("labels"), Ptr("lse"), Ptr("g"),
                Ptr("dh"), Ptr("dw")) + planes + (
            Ptr("st_hi"), Ptr("st_lo")) + codes + (
            sdw_d, sdw_v, float(softcap), chunk, H100_SMS, None)
        smem = xent_logits_smem(hlo, wlo, True)
        for t0 in range(0, T, chunk):
            tc = min(chunk, T - t0)
            launches.append(
                (f"xent_tc_logits_kernel<{_b(hlo)}, {_b(wlo)}, true>",
                 (_cdiv(tc, TBM), xent_nsplit(tc, V), 1), XENT_THREADS,
                 smem, smem))
            launches.append(_gemm_launch(False, True, wlo, tc, D))  # dH
            launches.append(_gemm_launch(True, True, hlo, V, D) if tied
                            else _gemm_launch(True, hlo, True, D, V))  # dW
        entry = "rt_xent_bwd_tc"
    expect = {"launches": tuple(launches),
              "guarded": () if hlo else ("h",)}
    return KernelConfig(name, tier, entry, tuple(bufs), args, expect)


# --- SSD: csrc/ssd_chunk.cu --------------------------------------------------

SSD_T, SSD_HG, SSD_THREADS = 64, 8, 256        # kT, kHG, kThreads
SSD_TILE_H = SSD_T * (SSD_T + 8)               # kTileH: a split plane
SSD_FRAG = 16                                  # kFrag
SSD_SPLIT = 2 * SSD_TILE_H                     # kSplit: kBwd planes


def ssd_fwd_smem(Q):
    """(smem_y, smem_s) of rt_ssd_intra."""
    njt = _cdiv(Q, SSD_T)
    y = (njt * SSD_FRAG * SSD_THREADS * 4 + 4 * 3 * SSD_TILE_H * 2
         + 12 * SSD_T * 4)
    return y, (njt + 4) * 3 * SSD_TILE_H * 2


def ssd_bwd_smem(Q):
    """(smem_dx, smem_bc) of rt_ssd_intra_bwd."""
    njt = _cdiv(Q, SSD_T)
    dx = (2 * njt * SSD_FRAG * SSD_THREADS * 4 + 5 * SSD_SPLIT * 2
          + (13 + 4 * njt) * SSD_T * 4)
    return dx, 2 * SSD_SPLIT * 2 + 2 * SSD_T * 4


def ssd(name, tier, backward, BC, Q, H, P, N):
    """One call of rt_ssd_intra or rt_ssd_intra_bwd: x (BC, Q, H, P), dt
    and a_cum (BC, Q, H), B and C (BC, Q, N) (B nc chunks as BC)."""
    njt, nnt, nhg = _cdiv(Q, SSD_T), _cdiv(N, SSD_T), _cdiv(H, SSD_HG)
    ins = (Buf("x", (BC, Q, H, P)), Buf("dt", (BC, Q, H), fill="dt"),
           Buf("acum", (BC, Q, H), fill="acum"), Buf("Bm", (BC, Q, N)),
           Buf("Cm", (BC, Q, N)))
    shape = (BC, Q, H, P, N, None)
    if not backward:
        y, s = ssd_fwd_smem(Q)
        bufs = ins + (Buf("y", (BC, Q, H, P), role="out"),
                      Buf("S", (BC, H, P, N), role="out"))
        args = tuple(Ptr(b.name) for b in bufs) + shape
        launches = (("ssd_y_kernel", (njt * nhg, BC, 1), SSD_THREADS, y, y),
                    ("ssd_state_kernel", (nnt * nhg, BC, 1), SSD_THREADS, s,
                     s))
        return KernelConfig(name, tier, "rt_ssd_intra", bufs, args,
                            {"launches": launches})
    scratch = BC * Q * (nhg * Q + njt * H)  # rt_ssd_intra_bwd_scratch_floats
    dx, bc = ssd_bwd_smem(Q)
    bufs = ins + (Buf("dy", (BC, Q, H, P)), Buf("dS", (BC, H, P, N))) + tuple(
        Buf("d" + b.name, b.shape, role="out") for b in ins) + (
        Buf("scratch", (scratch,), role="scratch"),)
    args = tuple(Ptr(b.name) for b in bufs) + (scratch,) + shape
    launches = [("ssd_bwd_dx_kernel", (njt * nhg * BC, 1, 1), SSD_THREADS,
                 dx, dx)]
    if nhg > 1:
        launches.append(("ssd_bwd_dcb_sum_kernel",
                         (_cdiv(Q * Q, SSD_THREADS), BC, 1), SSD_THREADS, 0,
                         -1))
    launches.append(("ssd_bwd_dbc_kernel", (njt * nnt, BC, 1), SSD_THREADS,
                     bc, -1))
    return KernelConfig(name, tier, "rt_ssd_intra_bwd", bufs, args,
                        {"launches": tuple(launches)})


# --- the matrix --------------------------------------------------------------

FA_KINDS = ("fwd", "fused", "dq", "dkv")


def _record_configs():
    out = []
    # the attention of the main paths' server steps (batch 8 x seq 512):
    # qwen3-1.7b (Hkv 8, G 2, hd 128) in both dtypes (the fp32 one is the
    # split step's fp32 pass and the fp32 smoke configs'), granite-moe-3b-
    # a800m (Hkv 8, G 3, hd 64); gemma2-2b's (Hkv 4, G 2, hd 256, window
    # 4096, softcap 50)
    for dt in ("bfloat16", "float32"):
        for kind in FA_KINDS:
            out.append(flash(f"qwen3_attn_{kind}_{dt}", "record", kind, 8, 8,
                             2, 512, 128, dt))
            out.append(flash(f"gemma2_attn_{kind}_{dt}", "record", kind, 8,
                             4, 2, 512, 256, dt, window=4096, softcap=50.0))
    for kind in FA_KINDS:
        out.append(flash(f"granite_attn_{kind}_bfloat16", "record", kind, 8,
                         8, 3, 512, 64, "bfloat16"))
    # gemma2-2b's own main path at its published context (chip_smoke phase
    # 20): the server step's attention at batch 2 x seq 8192, bf16, softcap
    # 50, on the local (window 4096) and the global layers, and the fp32
    # serving check's no-cache forward over prompt + 31 tokens
    for tag, window in (("local", 4096), ("global", 0)):
        for kind in ("fwd", "fused"):
            out.append(flash(f"gemma2_path_attn_{kind}_{tag}", "record",
                             kind, 2, 4, 2, 8192, 256, "bfloat16",
                             window=window, softcap=50.0))
        out.append(flash(f"gemma2_serve_fp32_fwd_{tag}", "record", "fwd", 2,
                         4, 2, 8223, 256, "float32", window=window,
                         softcap=50.0))
    # musicgen-large's main path: multi-head attention (Hkv 32, G 1, hd
    # 64) in the server step at batch 8 x seq 2048, the serving prefill at
    # batch 4 and the fp32 serving check's no-cache forward over prompt +
    # 31 tokens
    for kind in ("fwd", "fused"):
        out.append(flash(f"musicgen_path_attn_{kind}", "record", kind, 8, 32,
                         1, 2048, 64, "bfloat16"))
    out.append(flash("musicgen_prefill_bfloat16", "record", "fwd", 4, 32, 1,
                     2048, 64, "bfloat16"))
    out.append(flash("musicgen_serve_fp32_fwd", "record", "fwd", 4, 32, 1,
                     2079, 64, "float32"))
    # the serving prefill (chip_smoke phase 17: batch 4, the path's seq as
    # prompt); mamba2-370m's prefill runs the SSD forward over 8 chunks
    out.append(flash("qwen3_prefill_bfloat16", "record", "fwd", 4, 8, 2,
                     512, 128, "bfloat16"))
    out.append(flash("qwen3_prefill_float32", "record", "fwd", 4, 8, 2, 512,
                     128, "float32"))
    out.append(flash("granite_prefill_bfloat16", "record", "fwd", 4, 8, 3,
                     512, 64, "bfloat16"))
    out.append(ssd("mamba2_prefill", "record", False, 4 * 8, 256, 32, 64,
                   128))
    # the heads: qwen3-1.7b untied (T 8 x 511) with a bf16 and an fp32 h
    # and with bf16 weights, mamba2-370m (T 8 x 2047), granite (T 8 x
    # 511) and gemma2-2b (softcap 30) tied
    for bwd in (False, True):
        d = "bwd" if bwd else "fwd"
        out += [
            xent(f"qwen3_xent_{d}", "record", bwd, 4088, 2048, 151936),
            xent(f"qwen3_xent_{d}_h32", "record", bwd, 4088, 2048, 151936,
                 hdt="float32"),
            xent(f"qwen3_xent_{d}_w16", "record", bwd, 4088, 2048, 151936,
                 wdt="bfloat16"),
            xent(f"mamba2_xent_{d}", "record", bwd, 16376, 1024, 50280,
                 tied=True),
            xent(f"granite_xent_{d}", "record", bwd, 4088, 1536, 49155,
                 tied=True),
            xent(f"gemma2_xent_{d}", "record", bwd, 1024, 2304, 256000,
                 tied=True, softcap=30.0),
            # gemma2-2b's server head on its own path: T 2 x 8191
            xent(f"gemma2_path_xent_{d}", "record", bwd, 16382, 2304,
                 256000, tied=True, softcap=30.0),
            # musicgen-large's V 2048 heads: the server's untied one (T 8
            # x 2047) and the device's auxiliary one, tied to its
            # embedding (T 4 x 2047)
            xent(f"musicgen_xent_{d}", "record", bwd, 16376, 2048, 2048),
            xent(f"musicgen_aux_xent_{d}", "record", bwd, 8188, 2048, 2048,
                 tied=True)]
    # mamba2-370m's SSD at the server shape (B 8 x 8 chunks, Q 256, H 32,
    # P 64, N 128: every kMax at once) and a ragged head group at the same
    # maxima
    for bwd in (False, True):
        d = "bwd" if bwd else "fwd"
        out += [ssd(f"mamba2_ssd_{d}", "record", bwd, 64, 256, 32, 64, 128),
                ssd(f"ssd_max_{d}_h33", "record", bwd, 2, 256, 33, 64, 128)]
    return out


def _execute_configs():
    out = []
    # (tag, B, Hkv, G, Sq, hd, dtype, keywords): the emulated tests' rows
    fa = [
        ("win_cap_ragged", 1, 2, 2, 40, 16, "float32",
         dict(Skv=48, window=8, softcap=50.0, kv_len=45)),
        ("noncausal", 1, 4, 2, 32, 16, "bfloat16", dict(causal=False)),
        ("g4_win_cap", 1, 2, 4, 40, 32, "bfloat16",
         dict(window=16, softcap=30.0)),
        ("no_valid_key", 1, 1, 1, 80, 32, "bfloat16",
         dict(Skv=24, window=8, kv_len=21)),
        ("granite", 1, 2, 3, 130, 64, "bfloat16", {}),
        ("granite", 1, 2, 3, 130, 64, "float32", {}),
        ("hd256", 1, 1, 1, 40, 256, "bfloat16",
         dict(window=24, softcap=50.0)),
    ]
    for tag, B, Hkv, G, Sq, hd, dt, kw in fa:
        kinds = FA_KINDS if tag in ("win_cap_ragged", "noncausal",
                                    "g4_win_cap") else ("fwd", "fused")
        for kind in kinds:
            out.append(flash(f"fa_{tag}_{kind}_{dt}", "execute", kind, B,
                             Hkv, G, Sq, hd, dt, **kw))
    # xent: three vocabulary splits, three token chunks (dW accumulated
    # from the second), bf16 and fp32 h, fp32 and bf16 w, tied and softcap
    out += [xent("xent_fwd_splits", "execute", False, 80, 32, 300),
            xent("xent_bwd_chunks", "execute", True, 80, 32, 300, chunk=32),
            xent("xent_fwd_h32_tied", "execute", False, 40, 20, 130,
                 hdt="float32", wdt="bfloat16", tied=True, softcap=30.0),
            xent("xent_bwd_h32_tied", "execute", True, 40, 20, 130,
                 hdt="float32", wdt="bfloat16", tied=True, softcap=30.0,
                 chunk=32)]
    # SSD: two head groups (the dCB group sum), ragged q and N tiles
    out += [ssd("ssd_fwd_hg2", "execute", False, 1, 64, 9, 16, 16),
            ssd("ssd_bwd_hg2", "execute", True, 1, 64, 9, 16, 16),
            ssd("ssd_bwd_ragged", "execute", True, 2, 80, 2, 8, 72)]
    return out


KERNEL_CONFIGS = tuple(_record_configs() + _execute_configs())


def get_config(name: str) -> KernelConfig:
    for cfg in KERNEL_CONFIGS:
        if cfg.name == name:
            return cfg
    raise KeyError(name)

