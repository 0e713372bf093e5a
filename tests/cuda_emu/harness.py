"""Builds ``src/repro_torch/csrc/*.cu`` for the host, against the stub
headers in this directory, for the emulated kernel tests
(``tests/test_torch_kernels_emulated*.py``).

The sources are portable CUDA C++ apart from the PTX helpers of
``csrc/tensor_core.cuh``, which ``ptx_emu.h`` replaces with host
versions.  Two textual rewrites make them C++20: the ``<<<...>>>`` launch
becomes a call of the stub ``emu_launch``, and the dynamic
``extern __shared__`` array points at the stub's per-block buffer.  Each
source compiles in its own g++ process, all at once.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

from repro_torch.kernels import build

EMU = pathlib.Path(__file__).resolve().parent
LAUNCH = re.compile(r"([A-Za-z_][A-Za-z_0-9]*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(")
# extern __shared__ [__align__(n)] T name[];  ->  T* name = (T*)emu_dyn;
SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")


def compiler():
    """The host C++ compiler, or None."""
    return shutil.which("g++")


def build_library(out: pathlib.Path, patch=None):
    """Compile every kernel source into ``out`` and return the bound
    library (``build.bind``).  ``patch(name, text)``, where given, returns
    the text to compile for source ``name`` (a variant of the kernels)."""
    cxx = compiler()
    flags = ["-std=c++20", "-O2", "-fPIC", "-pthread", "-w", f"-I{EMU}",
             f"-I{build.CSRC}"]
    objs, procs = [], []
    for name in build.SOURCES:
        src = (build.CSRC / name).read_text()
        if patch is not None:
            src = patch(name, src)
        src = LAUNCH.sub(r"emu_launch(\1, \2, ", src)
        src = SHARED.sub(r"\1* \2 = (\1*)emu_dyn;", src)
        path = out / (name + ".cpp")
        path.write_text(src)
        objs.append(str(out / (name + ".o")))
        procs.append(subprocess.Popen([cxx, *flags, "-c", str(path), "-o",
                                       objs[-1]]))
    for p in procs:
        if p.wait(timeout=900):
            raise subprocess.CalledProcessError(p.returncode, p.args)
    so = out / "libemulated.so"
    subprocess.run([cxx, "-shared", "-pthread", *objs, "-o", str(so)],
                   check=True, timeout=300)
    return build.bind(ctypes.CDLL(str(so)))


def close(a, b, tol):
    """max |a - b| within ``tol`` of b's scale (at least 1)."""
    scale = max(1.0, float(b.abs().max()))
    err = float((a.float() - b.float()).abs().max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3e}"
