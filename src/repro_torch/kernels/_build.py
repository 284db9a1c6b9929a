"""Build the CUDA sources in ``csrc/`` and bind their launchers with ctypes.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, for ``sm_90a`` (Hopper).  All sources are
compiled at once, one ``nvcc`` process each, at first use (or when
``build_all`` is called), into ``kernels/build/`` beside this file -- a
directory that ``.gitignore`` lists.  A library's file name carries a hash
of its source, the shared header and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

nvcc with ctypes rather than ``torch.utils.cpp_extension.load``: a source
that includes PyTorch's headers takes minutes to compile, a plain C one
seconds, and every fresh machine builds anew.

Nothing here runs at import: the CPU tests import every module, and the
compiler is reached only when a CUDA tensor reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("inner_loop.cu", "round_tail.cu", "fused_update.cu", "gather.cu", "screen.cu",
           "stale_mix.cu", "residual.cu", "neighbor_reduce.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (PyTorch's own probe: $CUDA_HOME, the nvcc on
    PATH, /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME to the CUDA toolkit)")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def nvcc_command(nvcc: str, source: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / source)]


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{source: compiler output}`` for the sources compiled now
    (the ``-Xptxas -v`` register and shared-memory report); raises with the
    compiler's output if any compile fails."""
    with _lock:
        return _build_missing()


def _build_missing() -> dict[str, str]:
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for s in todo:
        tmp = library_path(s).with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, s, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for s, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[s] = out
        if p.returncode != 0:
            failed.append(s)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(s))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[s] for s in failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building every missing one first."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _build_missing()
            lib = ctypes.CDLL(str(library_path(source)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


P, F, I, LL = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong


class Kernel:
    """One CUDA kernel of this package: its C launcher and its launch count.

    ``launches`` is a plain integer that ``launch`` adds one to for every
    kernel it enqueues, and nothing else does; ``chip_smoke.py`` sets it to
    0 before driving the main path and reads it after."""

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        """Enqueue the kernel (the trailing ``device, stream`` arguments
        included in ``args``) and raise if CUDA refused it."""
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = load(self.source).repro_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: {msg} ({rc})")
        self.launches += 1

