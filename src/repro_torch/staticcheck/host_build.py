"""Build ``csrc/*.cu`` for the host, against the CUDA stand-in headers in
``emu/``, for the kernel analyzer and the emulated kernel tests.

The sources are portable CUDA C++ apart from the PTX helpers of
``csrc/tensor_core.cuh``, which ``emu/ptx_emu.h`` replaces with host
versions.  Three textual rewrites (:func:`host_source`) make them C++20:
the ``<<<...>>>`` launch becomes a call of the stub ``emu_launch`` that
names its launch site (``file.cu:line``); the dynamic ``extern __shared__``
array points at the stub's per-block buffer; and each source's anonymous
namespace gets a name of its own (``emu_<stem>``), so that its kernels are
exported symbols that ``dladdr`` can name.  Each source compiles in its own
g++ process, all at once.

The library lands in ``build/repro_torch_staticcheck/`` at the repository
root, named by a hash of the sources, the stand-in headers and the flags,
and is built on first use.  Besides the kernels' ``rt_*`` entry points
(:func:`repro_torch.kernels.build.bind`) it exports the emulator's records
(``emu/cuda_runtime.h``): :func:`reset`, :func:`launches`, :func:`turns`
and :func:`faults` read them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
from typing import Callable, List, NamedTuple, Optional

from repro_torch.kernels import build

EMU = pathlib.Path(__file__).resolve().parent / "emu"
EMU_HEADERS = ("cuda_runtime.h", "cuda_bf16.h", "ptx_emu.h")
LAUNCH = re.compile(r"([A-Za-z_][A-Za-z_0-9]*(?:<[^<>;()]*>)?)<<<(.*?)>>>\(")
# extern __shared__ [__align__(n)] T name[];  ->  T* name = (T*)emu_dyn;
SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")
ANON = re.compile(r"^namespace \{", re.M)
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-fno-semantic-interposition",
             "-pthread", "-w")

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
EMU_SIGNATURES = {
    "emu_reset": ([ctypes.c_int, ctypes.c_int], None),
    "emu_launch_count": ([], _LL),
    "emu_launch_get": ([_LL, _P], None),
    "emu_launch_site": ([_LL], ctypes.c_char_p),
    "emu_launch_name": ([_LL, ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "emu_turn_count": ([], _LL),
    "emu_turn_get": ([_LL, _P], None),
    "emu_fault_count": ([], _LL),
    "emu_fault_get": ([_LL, _P], _LL),
}
FAULT_KINDS = ("cp.async 16 dst", "cp.async 16 src", "cp.async 4 dst",
               "cp.async 4 src", "ldmatrix row")


def compiler() -> Optional[str]:
    """The host C++ compiler, or None."""
    return shutil.which("g++")


def host_source(name: str, text: str) -> str:
    """Source ``name`` (a file of ``csrc/``) as the host compiler takes it."""
    ns = "emu_" + pathlib.Path(name).stem

    def launch(m):
        line = text.count("\n", 0, m.start()) + 1
        return f'emu_launch("{name}:{line}", {m.group(1)}, {m.group(2)}, '

    text = LAUNCH.sub(launch, text)
    text = SHARED.sub(r"\1* \2 = (\1*)emu_dyn;", text)
    return ANON.sub(f"namespace {ns} {{}} using namespace {ns}; "
                    f"namespace {ns} {{", text)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for d, names in ((build.CSRC, build.SOURCES + build.HEADERS),
                     (EMU, EMU_HEADERS)):
        for name in names:
            h.update(name.encode())
            h.update((d / name).read_bytes())
    h.update(pathlib.Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def default_dir() -> pathlib.Path:
    return build.CSRC.parents[2] / "build" / "repro_torch_staticcheck"


def _compile(out: pathlib.Path, sources: dict) -> pathlib.Path:
    """Compile ``sources`` (file name -> CUDA text) for the host into one
    shared library in ``out``."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("repro_torch host build: g++ not found")
    flags = [*CXX_FLAGS, f"-I{EMU}", f"-I{build.CSRC}"]
    objs, procs = [], []
    for name, src in sources.items():
        path = out / (name + ".cpp")
        path.write_text(host_source(name, src))
        objs.append(str(out / (name + ".o")))
        procs.append(subprocess.Popen([cxx, *flags, "-c", str(path), "-o",
                                       objs[-1]]))
    for p in procs:
        if p.wait(timeout=900):
            raise subprocess.CalledProcessError(p.returncode, p.args)
    so = out / "libemulated.so"
    subprocess.run([cxx, "-shared", "-pthread", *objs, "-o", str(so), "-ldl"],
                   check=True, timeout=300)
    return so


def _kernel_sources(patch=None) -> dict:
    out = {}
    for name in build.SOURCES:
        text = (build.CSRC / name).read_text()
        out[name] = text if patch is None else patch(name, text)
    return out


def bind(lib, kernels: bool = True):
    """The emulator's C signatures on a loaded library, and the kernels'
    (``kernels``)."""
    if kernels:
        build.bind(lib)
    for name, (argtypes, restype) in EMU_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_library(out: Optional[pathlib.Path] = None,
                  patch: Optional[Callable[[str, str], str]] = None):
    """Compile every kernel source for the host and return the bound
    library.  ``out``: the directory to build in (default: the cached
    library under ``build/repro_torch_staticcheck/``, built unless an
    identical one exists).  ``patch(name, text)``, where given, returns the
    text to compile for source ``name`` (a variant of the kernels; it needs
    ``out``)."""
    if out is not None:
        so = _compile(pathlib.Path(out), _kernel_sources(patch))
        return bind(ctypes.CDLL(str(so)))
    if patch is not None:
        raise ValueError("a patched build needs a directory of its own")
    so = default_dir() / f"libemulated_{source_hash()}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
            os.replace(_compile(pathlib.Path(tmp), _kernel_sources()), so)
    return bind(ctypes.CDLL(str(so)))


def build_sources(out: pathlib.Path, sources: dict):
    """Compile other CUDA sources (file name -> text; they may include
    ``csrc/``'s headers) for the host in ``out`` and return the library
    with the emulator's signatures bound (toy kernels, for tests)."""
    return bind(ctypes.CDLL(str(_compile(pathlib.Path(out), sources))),
                kernels=False)


class Launch(NamedTuple):
    kernel: str          # demangled, without namespace and parameters
    site: str            # "file.cu:line" of the <<<...>>>
    grid: tuple
    block: tuple
    smem: int            # dynamic shared memory requested
    attr: int            # last MaxDynamicSharedMemorySize set; -1 none


class Turn(NamedTuple):
    launch: int
    block: int           # linear block index (x fastest)
    passed: bool         # pass_turn (True) or wait_turn
    counter: int         # address
    value: int
    ok: bool             # a wait found the counter at its turn


class Fault(NamedTuple):
    launch: int
    block: int
    lane: int
    kind: str            # FAULT_KINDS
    address: int


def reset(lib, record_only: bool = False, turn_abort: bool = True) -> None:
    """Clear the records and set the mode: ``record_only`` runs no kernel
    body and no copy; ``turn_abort`` aborts the process on a wrong turn
    (else it is logged)."""
    lib.emu_reset(int(record_only), int(turn_abort))


def kernel_name(symbol: str) -> str:
    """``void emu_xent::k<true, false>(float const*, ...)`` -> ``k<true,
    false>``: the name without return type, namespace and parameters."""
    if symbol.startswith("void "):
        symbol = symbol[5:]
    depth = 0
    for i, c in enumerate(symbol):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0:
            symbol = symbol[:i]
            break
    return re.sub(r"^emu_\w+::", "", symbol)


def launches(lib) -> List[Launch]:
    out, buf = [], ctypes.create_string_buffer(4096)
    vals = (ctypes.c_longlong * 8)()
    for i in range(lib.emu_launch_count()):
        lib.emu_launch_get(i, vals)
        name = (kernel_name(buf.value.decode())
                if lib.emu_launch_name(i, buf, len(buf)) == 0 else "?")
        out.append(Launch(name, lib.emu_launch_site(i).decode(),
                          tuple(vals[0:3]), tuple(vals[3:6]), vals[6],
                          vals[7]))
    return out


def turns(lib) -> List[Turn]:
    out, vals = [], (ctypes.c_longlong * 6)()
    for i in range(lib.emu_turn_count()):
        lib.emu_turn_get(i, vals)
        out.append(Turn(vals[0], vals[1], bool(vals[2]), vals[3], vals[4],
                        bool(vals[5])))
    return out


def faults(lib) -> tuple:
    """(total count, the first records kept)."""
    kept, vals = [], (ctypes.c_longlong * 5)()
    i = 0
    while lib.emu_fault_get(i, vals) == 0:
        kept.append(Fault(vals[0], vals[1], vals[2], FAULT_KINDS[vals[3]],
                          vals[4]))
        i += 1
    return lib.emu_fault_count(), kept
