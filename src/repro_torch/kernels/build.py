"""Build and load the hand-written CUDA kernels.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles every
``csrc/*.cu`` (one nvcc per source, all started together) into one shared
library with a plain C interface, loaded with ``ctypes``.  Nothing here
includes PyTorch's headers, so a cold build takes seconds, not minutes.
The library lands in ``build/repro_torch_kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides), named by a hash of the sources and
flags, and is built on first use — never at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_attention.cu", "xent.cu", "ssd_chunk.cu")
HEADERS = ("common.cuh", "tensor_core.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "rt_flash_plane_elems": [_I, _LL, _LL],
    "rt_flash_split": [_P, _P, _LL, _I, _P],
    "rt_flash_fwd": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P],
    "rt_flash_bwd_tiles": [_I, _I, _P, _P],
    "rt_flash_bwd": [_P] * 11 + [_LL] + [_I] * 8 + [_F, _F, _I, _P],
    "rt_flash_bwd_dq": [_P] * 8 + [_I] * 8 + [_F, _F, _I, _P],
    "rt_flash_bwd_dkv": [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P],
    "rt_xent_tc_nsplit": [_I] * 3,
    "rt_xent_split": [_P] * 3 + [_I] * 3 + [_LL, _LL, _P],
    "rt_xent_split_h": [_P] * 3 + [_I] * 2 + [_P],
    "rt_xent_fwd_tc": [_P] * 10 + [_I] * 5 + [_LL, _LL, _F, _I, _P],
    "rt_xent_bwd_tc": [_P] * 13 + [_I] * 5 + [_LL] * 4 + [_F, _I, _I, _P],
    "rt_ssd_intra": [_P] * 7 + [_I] * 5 + [_P],
    "rt_ssd_intra_bwd_scratch_floats": [_I] * 3,
    "rt_ssd_intra_bwd": [_P] * 13 + [_LL] + [_I] * 5 + [_P],
    "rt_smem_optin": [_P],
}
# each source's table of kernel instantiations (common.cuh::
# RT_KERNEL_TABLE)
TABLES = ("flash", "xent", "ssd")
for _t in TABLES:
    SIGNATURES[f"rt_{_t}_kernel_count"] = []
    SIGNATURES[f"rt_{_t}_kernel_name"] = [_I]
    SIGNATURES[f"rt_{_t}_kernel_attrs"] = [_I, _I, _LL, _LL, _P]
RESTYPES = {"rt_flash_plane_elems": _LL,   # others return int
            "rt_ssd_intra_bwd_scratch_floats": _LL,
            **{f"rt_{t}_kernel_name": ctypes.c_char_p for t in TABLES}}

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            DEFAULT_NVCC]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("repro_torch kernels: nvcc not found (set CUDA_HOME)")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_kernels_{_source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the shared library unless an identical one exists.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per kernel).
    """
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src}]\n{log}", flush=True)
            if proc.returncode:
                failed.append(f"{src}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_so),
                        *map(str, objs)], check=True)
        os.replace(tmp_so, out)
    return out


def bind(lib):
    """Declare the C signatures on a loaded library (ctypes would otherwise
    pass every argument as a 32-bit int)."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


ATTR_KEYS = ("regs", "spill_bytes", "static_smem", "max_dyn_smem",
             "max_threads", "blocks_per_sm")


def kernel_table(lib) -> dict:
    """Every kernel instantiation of the sources: name -> (table, index)."""
    out = {}
    for t in TABLES:
        name = getattr(lib, f"rt_{t}_kernel_name")
        for i in range(getattr(lib, f"rt_{t}_kernel_count")()):
            out[name(i).decode()] = (t, i)
    return out


def kernel_attrs(lib, where, threads: int, smem: int, attr: int) -> dict:
    """The card's attributes of one table entry (``kernel_table``'s value)
    launched with ``threads`` and ``smem`` bytes of dynamic shared memory
    after its launch site set the attribute to ``attr`` (none if < 0):
    registers, spill bytes, static shared memory, the dynamic limit, the
    thread limit and blocks an SM (common.cuh::kernel_attrs)."""
    table, i = where
    out = (ctypes.c_longlong * len(ATTR_KEYS))()
    fn = getattr(lib, f"rt_{table}_kernel_attrs")
    check(lib, fn(i, threads, smem, attr, out), f"kernel_attrs {table}[{i}]")
    return dict(zip(ATTR_KEYS, out))


def check(lib, err: int, what: str):
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel inputs must be float32 or bfloat16, "
                        f"got {t.dtype}") from None
