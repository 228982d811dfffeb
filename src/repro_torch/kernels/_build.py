"""Build, load and count the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain ``extern "C"`` interface and loaded with
``ctypes``: pointers and the stream pass as ``c_void_p``, and every entry
point returns ``cudaGetLastError()`` after its launch, which
:func:`check_launch` turns into an exception.  Nothing here includes
PyTorch's headers, so a build takes seconds.

Libraries go to ``build/kernels/`` at the repository root, named by a
hash of the sources and flags: a process builds each one at most once,
and a checkout builds it on first use.  ``--fmad=false`` keeps every
float multiply and add separately rounded, so the fused epilogue is bit
for bit the plain version's.

Launch counts: each kernel wrapper calls :func:`count_launch` once per
launch, after the launch succeeded, so a run can show which kernels its
main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "nvcc_path", "build",
           "build_log", "load", "check_launch", "count_launch",
           "launches", "reset_launches"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

# library name -> its source in csrc/
SOURCES = {"lowbit_gemm": "lowbit_gemm.cu", "lowbit_conv": "lowbit_conv.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> (entry point, argtypes); every entry point returns int
_SIGNATURES = {
    # mode, fused, a0, a1, b0, b1, m, n, kw, k_valid, row, col, bias, out,
    # stream
    "lowbit_gemm": ("lowbit_gemm_launch",
                    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                     _P]),
    # mode, x, B, H, W, C, kh, kw, stride, pad_top, pad_left, OH, OW,
    # b0, b1, cout, words, k_valid, thr, scale, col, bias, out, stream
    "lowbit_conv": ("lowbit_conv_launch",
                    [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHES: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, pathlib.Path]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    per source, all started together.  Returns name -> library path."""
    names = list(names)
    paths = {n: _library_path(n) for n in names}
    with _LOCK:
        todo = [n for n in names if not paths[n].exists()]
        if not todo:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[n])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((n, tmp, proc))
        failed = []
        for n, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed for {SOURCES[n]} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            paths[n].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    from the build of library ``name``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    entry, argtypes = _SIGNATURES[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.lowbit_error_string.argtypes = [ctypes.c_int]
    lib.lowbit_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.lowbit_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({msg})")


def count_launch(key: str) -> None:
    _LAUNCHES[key] += 1


def launches() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`, by
    ``<kernel>_<mode>[_<variant>]``."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()
