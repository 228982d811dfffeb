"""Build, load, launch and count the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain ``extern "C"`` interface and loaded with
``ctypes``.  Nothing here includes PyTorch's headers, so a build takes
seconds.  The libraries and their entry points:

* ``lowbit_gemm``: ``lowbit_gemm_launch`` (popcount GeMM, fused or int32);
* ``lowbit_gemm_grouped``: ``lowbit_gemm_grouped_launch`` (fused popcount
  GeMMs of several groups of rows, each against its own weights, in one
  launch);
* ``lowbit_conv``: ``conv_pack_launch`` (quantize + pack the padded
  input once), ``lowbit_conv_launch`` (popcount implicit-im2col conv),
  ``conv_stats_launch`` (the activation statistics the pack quantizes
  with, one or two passes);
* ``dense_tc``: ``dense_gemm_launch``, ``dense_conv_launch`` (planes
  decoded to int8, tensor cores);
* ``affine_gemm``: ``affine_gemm_launch`` (u8 / u4 raw accumulator).

Every kernel wrapper launches through :func:`launch`: pointers and the
stream pass as plain ints (the ``argtypes`` declare ``c_void_p``; None is
a null pointer), on the current stream of the operands' device; every
entry point returns ``cudaGetLastError()`` after its launch, which
:func:`launch` turns into an exception.

Libraries go to ``build/kernels/`` at the repository root, named by a
hash of the sources and flags: a process builds each one at most once,
and a checkout builds it on first use.  ``--fmad=false`` keeps every
float multiply and add separately rounded, so the fused epilogue is bit
for bit the plain version's.

Launch counts: :func:`launch` counts each launch under the wrapper's key,
after the launch succeeded, so a run can show which kernels its main path
went through: ``lowbit_gemm_<mode>_{fused,i32}``,
``lowbit_gemm_grouped_<mode>``, ``conv_pack_<mode>``,
``lowbit_conv_<mode>``, ``conv_stats_<mode>``, ``dense_gemm_<mode>``, ``dense_conv_<mode>``,
``affine_gemm_{u8,u4}``.

Records on ``meta``: a wrapper whose operands all lie on the ``meta``
device (the dry-run, ``launch/dryrun.py``) launches nothing and runs no
plain version; it calls :func:`record` with the kernel's problem (its
dims, under the key :func:`launch` would count) and returns an empty
``meta`` output of the kernel's shape and dtype.  :func:`records` reads
them in order; ``repro_torch.roofline.analysis.kernel_work`` turns each
into operations and bytes.
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
from typing import Dict, Iterable, List, Tuple

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "nvcc_path", "build",
           "build_log", "load", "launch", "launches", "reset_launches",
           "record", "records", "reset_records"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"

# library name -> its source in csrc/
SOURCES = {"lowbit_gemm": "lowbit_gemm.cu", "lowbit_conv": "lowbit_conv.cu",
           "dense_tc": "dense_tc.cu", "affine_gemm": "affine_gemm.cu",
           "lowbit_gemm_grouped": "lowbit_gemm_grouped.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# library name -> {entry point: argtypes}; every entry point returns int
_SIGNATURES = {
    # mode, fused, a0, a1, b0, b1, m, n, kw, k_valid, tile, row, row_stride,
    # col, bias, out, stream
    "lowbit_gemm": {"lowbit_gemm_launch":
                    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
                     _P, _P, _P]},
    # mode, a0, a1, rows, counts, groups, b0, b1, n, kw, k_valid, tile, row,
    # col, bias, out, stream
    "lowbit_gemm_grouped": {"lowbit_gemm_grouped_launch":
                            [_I, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P]},
    "lowbit_conv": {
        # mode, x, B, H, W, C, Hp, Wp, pad_top, pad_left, thr, p0, p1, stream
        "conv_pack_launch": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P],
        # mode, a0, a1, B, Hp, Wp, C, kh, kw, stride, OH, OW, b0, b1, cout,
        # words, k_valid, scale, col, bias, out, stream
        "lowbit_conv_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
        # mode, x, B, H, W, C, kh, kw, stride, OH, OW, pad_top, pad_left,
        # scratch, scratch bytes, out, stream
        "conv_stats_launch": [_I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P, _I, _P, _P]},
    "dense_tc": {
        # mode, a0, a1, b0, b1, m, n, kw, k_valid, tile, row, row_stride,
        # col, bias, out, stream
        "dense_gemm_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                              _I, _P, _P, _P, _P],
        # mode, a0, a1, B, Hp, Wp, C, kh, kw, stride, OH, OW, b0, b1, cout,
        # words, scale, col, bias, out, stream
        "dense_conv_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P, _P, _I, _I, _P, _P, _P, _P, _P]},
    # u4, a, b, m, n, k, tile, out, stream
    "affine_gemm": {"affine_gemm_launch": [_I, _P, _P, _I, _I, _I, _I, _P, _P]},
}

_LIBRARY_OF = {entry: name for name, entries in _SIGNATURES.items()
               for entry in entries}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Tuple[ctypes.CDLL, object]] = {}
_LAUNCHES: collections.Counter = collections.Counter()
_RECORDS: List[Tuple[str, Dict[str, int]]] = []


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
    for entry, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lowbit_error_string.argtypes = [ctypes.c_int]
    lib.lowbit_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def launch(entry: str, key: str, device: int, *args) -> None:
    """Launch the kernel behind ``entry`` (an entry point of a ``csrc``
    library, built and loaded on first use) with ``args`` and the current
    stream of CUDA device ``device``; raise if the launch failed, else
    count it under ``key``.  Pointers in ``args`` are ints (None: null).
    The runtime launches on its current device, so ``device`` is made
    current for the call when it is not."""
    bound = _ENTRIES.get(entry)
    if bound is None:
        lib = load(_LIBRARY_OF[entry])
        bound = _ENTRIES[entry] = (lib, getattr(lib, entry))
    lib, fn = bound
    # _cuda_getCurrentRawStream: the int torch.cuda.current_stream(device)
    # .cuda_stream gives, without building a Stream object per launch
    if device == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        msg = lib.lowbit_error_string(rc).decode()
        raise RuntimeError(f"{key}: CUDA launch failed with error {rc} "
                           f"({msg})")
    _LAUNCHES[key] += 1


def launches() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`, by
    ``<kernel>_<mode>[_<variant>]``."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    _LAUNCHES.clear()


def record(key: str, **problem: int) -> None:
    """Record, in place of a launch on ``meta`` operands, the problem of
    the kernel counted under ``key`` (module docstring)."""
    _RECORDS.append((key, {k: int(v) for k, v in problem.items()}))


def records() -> List[Tuple[str, Dict[str, int]]]:
    """(key, problem) of every kernel recorded on ``meta`` since the last
    :func:`reset_records`, in call order."""
    return list(_RECORDS)


def reset_records() -> None:
    _RECORDS.clear()
