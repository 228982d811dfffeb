#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the kernels from this checkout, holds every kernel
against its plain PyTorch version, drives the main path, times it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times [--src DIR]

The second form runs phases 1, 2 and the GeMM rows of phase 6 only
(popcount, dense, u8 and u4), for the ``repro_torch`` package under
``DIR`` (default this checkout's ``src``): the way to time another
checkout's GeMM kernels, e.g. the parent commit's, on the same card.

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and count, ``nvidia-smi``'s name and power
   limit;
2. build — ``nvcc`` for ``sm_90a``, one process per ``csrc/*.cu``, and
   ``-Xptxas -v``'s register / shared-memory / spill lines;
3. GeMM kernel vs plain on the card — TNN/TBN/BNN, int32 core and fused
   (the row scale as (m, 1) values, one per-tensor value, and that value
   expanded to (m, 1); with and without bias), at every ``GEMM_GRID``
   shape, the CNN's im2col shapes at batch 8 and ``GEMM_EXTRA`` (ragged
   m, n and k, every CTA tile of the plan, A streamed), plus planes at a
   4-byte, not 16-byte, aligned offset: ``torch.equal``;
4. conv kernels vs plain — every ``PAPER_CNN`` low-bit layer geometry
   at full width, batch 8, in all three modes, plus a Cin % 32 != 0, a
   stride-2 VALID and two deep geometries (the A tile streamed instead of
   resident): the packing pass (``conv_pack_kernel``) and the popcount
   conv (pack + conv) ``torch.equal`` to their plain versions;
4b. the dense backend's tensor-core kernels vs plain — the dense GeMM at
   the shapes of phase 3 (and the offset planes) and the dense conv at
   the geometries of phase 4, each mode, with and without bias:
   ``torch.equal`` to the plain version and to the popcount kernel; the
   u8 and u4 kernels at every ``GEMM_GRID`` shape, ``AFFINE_EXTRA``
   (ragged m, n and k, both tiles, a CTA walking several row blocks, B
   staged in chunks) and the CNN's im2col shapes at batch 8, and on
   operands 1, 4 and 8 bytes past a 16-byte boundary, operands over the
   full 0..255 / 0..15 range: ``torch.equal``;
5. the main path, launch counters zeroed just before and read just
   after: ``qmm`` and ``packed_matmul`` requests at the paper's GEMM_GRID
   diagonal in all three modes, then ``PaperCNN(PAPER_CNN)`` at full
   width (img 32, channels 32-64-128-128-256) on 4 batches of 256 images
   (the first a warm-up).  Every kernel must have launched, the packing
   pass once per conv launch (pack + conv per low-bit layer); the logits
   must be finite; a batch must be ``torch.equal`` to the same module
   run through the plain versions, layer by layer; each low-bit layer
   must equal the materializing oracle (im2col + ``qmm``); a small CNN
   on the card must match the CPU run to 1e-5; a ``qmm`` request must
   launch its quantization's kernels and one GeMM, nothing else (no copy
   of the per-tensor activation scale; torch.profiler);
5b. the second main path, counters zeroed just before and read just
   after: ``qmm`` at the GEMM_GRID diagonal for f32, u8, u4 and, on
   ``backend="dense"``, TNN/TBN/BNN, then ``PaperCNN(PAPER_CNN,
   backend="dense")`` on 4 batches of 256 (the first a warm-up).  Every
   dense and affine kernel must have launched, the packing pass once per
   dense conv launch; the dense qmm outputs, the
   dense CNN's logits and every layer's map must be ``torch.equal`` to
   the popcount run's; u8/u4 ``qmm`` equal to the plain backend;
5c. Table III on the card: the integer cores of the six algorithms (f32
   ``torch.matmul``, the u8 and u4 kernels, the TNN/TBN/BNN popcount
   int32 kernels) over all 64 ``GEMM_GRID`` shapes on pre-packed
   operands — mean time per algorithm on the host clock (CUDA events
   around back-to-back calls) and on the device (``torch.profiler``),
   and the ratio matrix ``E[T_row / T_col]`` of
   ``benchmarks/bench_matmul.py``;
6. times — CUDA events after warm-up, per kernel x mode at the main
   path's shapes: kernel, plain version, the least time the card could
   take (popcounts at 16 per clock per SM on 132 SMs at the maximum SM
   clock, or bytes at 3.35 TB/s, whichever is larger) and one PyTorch
   call computing the same product on +-1/0 values (``library_ms``, a
   yardstick the port never calls; for the convs float32 ``F.conv2d``,
   and ``library_bf16_ms`` bf16 ``F.conv2d`` in channels_last), plus each
   kernel's own device time (a conv row: its wrapper, pack + conv, and
   both kernels' device time)
   and one CNN batch's device time by kernel from ``torch.profiler``
   (popcount and dense); the tensor-core kernels' bound is 2*m*n*k at the
   int8 rate of 1,979 TOP/s or bytes at 3.35 TB/s, whichever is larger.
   The GeMM rows (:func:`gemm_rows`; popcount, dense, u8 and u4) add the
   host us per call, the library call's device time, one ``qmm``
   request's time, and the same times at the CNN's im2col GeMM shapes at
   batch 256, whose outputs are held against the plain versions and
   dense against popcount (u8/u4 also beside ``torch._int_mm``);
7. the LM path (7a-7c run after phase 5b's timed CNN batches, before
   any profiler session; 7d after phase 6), counters zeroed just before
   each run and read just after:
   7a. TinyLlama-1.1B at its published width and depth (22 layers,
       d_model 2048, 32 heads / 4 KV heads, d_ff 5632, vocab 32000,
       bf16), random weights from a generator on the card, packed with
       ``pack_lm_params`` under ``tnn``: prefill 4 prompts of 128 tokens,
       16 greedy decode steps; exactly 7 x 22 fused TNN GeMM launches per
       forward and nothing else; finite logits; every logits tensor and
       the tokens ``torch.equal`` to the same run on ``backend="torch"``
       (the plain versions, no cut) and to the QAT run (master weights
       through ``quantized_matmul``); prefill tokens/s and decode
       ms/token for ``tnn`` packed and ``bf16`` (host clock around
       synchronized work, after a warm-up), packed projection bytes;
   7b. the same model at full width and 2 layers under ``bnn``,
       ``tnn_dense`` and ``int8``, 2 decode steps each: each launches its
       GeMM kernel (``lowbit_gemm`` BNN, ``dense_gemm_kernel``,
       ``affine_gemm`` u8) 7 x 2 times per forward and equals its plain
       run;
   7c. ``QuantLinear(2048, 5632, TNN)`` on the card: forward ==
       ``qmm(x, pack(w))``; ``gx`` and ``gw`` within the float32
       summation bound of the float64 STE formula, ``gx`` zero where
       ``|x| > 1``;
   7d. torch.profiler over one prefill and one decode step of the tnn
       model: device kernel time, kernels launched, busy share against
       the unprofiled host times of 7a;
8. the rest of the model layer (right after 7c, before any profiler
   session), counters zeroed just before each run and read just after,
   every model at its published width, random weights from a generator
   on the card, packed under ``tnn`` (each expert, SSM and attention
   projection a fused TNN GeMM launch):
   8a. Qwen2-MoE-A2.7B (24 layers, d_model 2048, 16 heads, 60 experts
       top-4 of d_ff 1408, a shared FFN of 5632, vocab 151936, bf16):
       4 prompts x 128, ``MOE_STEPS`` greedy steps; exactly (4 + 3 +
       3 x 60) x 24 launches per forward (every expert runs on its
       capacity rows) and nothing else; every logits tensor and the
       tokens ``torch.equal`` to the plain run and to the QAT run;
       prefill tokens/s, decode ms/token and its bound, the aux loss;
   8b. Mamba2-1.3B (48 layers, d_inner 4096, 64 SSD heads of 64, state
       128, chunk 256, vocab 50280, tied): 4 prompts x 512 (two SSD
       chunks), 16 steps; 2 x 48 launches per forward; the same checks;
   8c. TinyLlama-1.1B (phase 7a's packed weights) on the paged ternary
       cache (``kv_cache_dtype="tnn2"``): the prompts in chunks of 32
       through ``EntryPager`` / ``sync_page_tables`` into 16-token pages,
       16 steps; 7 x 22 launches per forward; ``torch.equal`` to the
       plain run; the ``tnn2-oracle`` run, in chunks of 32 and with the
       prompt as one chunk, against 7a's bf16 slab run (tokens agreeing,
       max abs logit difference); cache bytes bf16 /
       tnn2 (``tree_nbytes``); the allocator balanced after release;
   8d. the indexed policies (``tnn_indexed``, ``bnn_indexed``,
       ``tnn_mixed``) on TinyLlama at full width and 2 layers, 2 steps:
       logits and tokens ``torch.equal`` to the popcount backend under
       the same mode; ms/token;
9. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

SMS = 132                    # H100 SXM
POPC_PER_CLK_PER_SM = 16     # CUDA programming guide, compute capability 9.0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
MODES = ("tnn", "tbn", "bnn")
NPOPC = {"tnn": 2, "tbn": 2, "bnn": 1}       # POPC per output per word
GEMM_REPLACES = {
    ("tnn", True): "src/repro/kernels/tnn_matmul.py:93",
    ("tnn", False): "src/repro/kernels/tnn_matmul.py:58",
    ("tbn", True): "src/repro/kernels/tbn_matmul.py:90",
    ("tbn", False): "src/repro/kernels/tbn_matmul.py:55",
    ("bnn", True): "src/repro/kernels/bnn_matmul.py:89",
    ("bnn", False): "src/repro/kernels/bnn_matmul.py:51",
}
CONV_REPLACES = "src/repro/kernels/conv_fused.py:369"
# the Pallas conv's in-kernel quantize + pack, now a pass of its own
PACK_REPLACES = "src/repro/kernels/conv_fused.py:369 (in-kernel quantize + pack)"
GEMM_SOURCE = "src/repro_torch/kernels/csrc/lowbit_gemm.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/lowbit_conv.cu"
DENSE_SOURCE = "src/repro_torch/kernels/csrc/dense_tc.cu"
AFFINE_SOURCE = "src/repro_torch/kernels/csrc/affine_gemm.cu"
DENSE_GEMM_REPLACES = "src/repro/kernels/dense_fused.py:104"
DENSE_CONV_REPLACES = "src/repro/kernels/dense_fused.py:181"
AFFINE_REPLACES = {"u8": "src/repro/kernels/int8_matmul.py:28",
                   "u4": "src/repro/kernels/int4_matmul.py:66"}
INT8_OPS_PER_S = 1.979e15    # H100 SXM data sheet, dense int8 tensor cores
TABLE3 = ("f32", "u8", "u4", "tnn", "tbn", "bnn")
# The paper's Cortex-A73 speed-ups (time of the second / time of the
# first), as benchmarks/bench_matmul.py prints them.
PAPER_A73 = {"tnn/f32": 3.63, "tbn/f32": 3.75, "bnn/f32": 10.9, "tnn/u8": 2.51,
             "tnn/u4": 1.44, "bnn/tnn": 2.99}
BATCH, BATCHES = 256, 4
# Phase 3/4b GeMM geometries beside GEMM_GRID and the CNN's im2col shapes:
# ragged m, n and k (kw % 4 != 0: the dense kernel's 4-byte weight
# copies), the plan's 32 tile (1000 x 130 on 132 SMs), A streamed instead
# of resident (kw = 129 in 64-row tiles, 500 in 16-row tiles).
GEMM_EXTRA = [(37, 21, 130), (1, 1, 1), (5, 3, 33), (1000, 130, 1152), (9000, 64, 4128),
              (40, 20, 16000)]
MISALIGNED = (100, 70, 512)   # (m, n, k): kw % 4 == 0, planes 4 bytes off 16
# Phase 4b u8/u4 geometries beside GEMM_GRID and the CNN's im2col shapes:
# an odd depth (the u4 nibble pad), one output, k % 16 != 0, n % 4 != 0
# with n % 16 != 0, m below a tile, an odd depth with n % 4 == 0, and the
# plan's 64 tile (the last three on 132 SMs; every other shape takes 32),
# more row blocks than the card holds CTAs (60000 x 32: a CTA walks
# several), a depth past the B chunk a CTA holds (1200 > 1152); then
# operands 1, 4 and 8 bytes past a 16-byte boundary (the launcher's 1-, 4-
# and 8-byte copies of A, byte loads of B below 4).
AFFINE_EXTRA = [(37, 21, 131), (1, 1, 1), (100, 64, 200), (90, 30, 256), (5, 70, 64),
                (33, 40, 77), (2100, 300, 96), (60000, 32, 288), (20000, 64, 1200)]
AFFINE_MISALIGNED = ((130, 72, 256), (1, 4, 8))     # (m, n, k), byte offsets
# Phase 7, the LM path: TinyLlama-1.1B at its published width and depth,
# 4 prompts of 128 tokens, 16 greedy decode steps; the other policies at
# full width and LM_CUT_LAYERS layers, LM_CUT_STEPS steps each.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "tinyllama-1.1b", 4, 128, 16
LM_CUT_LAYERS, LM_CUT_STEPS = 2, 2
# policy -> the GeMM kernel its projections launch
LM_POLICY_KERNELS = {"tnn": "lowbit_gemm_tnn_fused", "bnn": "lowbit_gemm_bnn_fused",
                     "tnn_dense": "dense_gemm_tnn", "int8": "affine_gemm_u8"}
PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "in_proj", "out_proj")
# Phase 8, the rest of the model layer at published width: Qwen2-MoE-A2.7B
# (MOE_STEPS greedy steps after 4 x 128), Mamba2-1.3B (4 x SSM_PROMPT, two
# SSD chunks, SSM_STEPS steps), TinyLlama-1.1B on the paged ternary cache
# (prefill in PAGED_CHUNK-token chunks into PAGED_PAGE-token pages) and
# the indexed policies at LM_CUT_LAYERS layers.
MOE_ARCH, MOE_STEPS = "qwen2-moe-a2.7b", 3
SSM_ARCH, SSM_PROMPT, SSM_STEPS = "mamba2-1.3b", 512, 16
PAGED_CHUNK, PAGED_PAGE = 32, 16
INDEXED_POLICIES = {"tnn_indexed": "tnn", "bnn_indexed": "bnn", "tnn_mixed": "tnn"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled(fn):
    """(key_averages rows of the CUDA kernels one ``fn()`` ran, host ms)
    from ``torch.profiler``: [(kernel name, device ms, calls), ...]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1]), host_ms


def kernel_device_ms(fn, pattern, reps: int = 1):
    """Device ms per ``fn()`` of the kernels whose names contain
    ``pattern`` (a string, "" for every kernel, or a tuple of strings),
    over ``reps`` calls, or None when three profiler sessions recorded
    none (a session now and then records no device events)."""
    pats = (pattern,) if isinstance(pattern, str) else tuple(pattern)

    def run():
        for _ in range(reps):
            fn()
    for _ in range(3):
        total = sum(ms for name, ms, _ in profiled(run)[0] if any(p in name for p in pats))
        if total:
            return total / reps
    return None


def kernel_launches(fn) -> int:
    """CUDA kernels one ``fn()`` launched, by torch.profiler: the most that
    any of three sessions recorded (a session now and then drops some or
    all of its device events; none records a kernel that did not run)."""
    n = max(sum(calls for _, _, calls in profiled(fn)[0]) for _ in range(3))
    if not n:
        raise AssertionError("the profiler recorded no kernel in three sessions")
    return n


def tc_bound(ops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time for ``ops`` int8
    tensor-core operations and ``nbytes`` of device memory traffic."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def layer_by_layer(cfg, model_a, model_b, x, check, name_of, what):
    """Run two PaperCNNs on ``x`` layer by layer; every low-bit layer's
    map must be equal (``check.equal`` under ``name_of(mode)``)."""
    import torch

    h_a = h_b = x
    for i, (spec, la, lb) in enumerate(zip(cfg.convs, model_a.layers, model_b.layers)):
        h_a, h_b = la(h_a), lb(h_b)
        if spec.mode != "bf16":
            check.equal(name_of(spec.mode), h_a, h_b, f"{what} layer {i}")
        h_a, h_b = torch.relu(h_a), torch.relu(h_b)
        if spec.pool:
            b, hh, ww, c = h_a.shape
            h_a = h_a.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
            h_b = h_b.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


class Checker:
    """Largest |kernel - plain| per kernel name; any difference fails."""

    def __init__(self):
        self.max_err = {}

    def equal(self, name: str, got, want, what: str) -> None:
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from its plain version "
                                 f"(max abs err {err})")


def gemm_operands(mode, m, n, k, device, gen):
    import torch
    from repro_torch.core import encoding

    a = torch.randint(-1, 2, (m, k), generator=gen, device=device).float()
    b = torch.randint(-1, 2, (n, k), generator=gen, device=device).float()
    a_pl = list(encoding.pack_ternary(a)) if mode != "bnn" else [encoding.pack_binary(a)]
    b_pl = list(encoding.pack_ternary(b)) if mode == "tnn" else [encoding.pack_binary(b)]
    row = torch.rand((m, 1), generator=gen, device=device) + 0.5
    col = torch.rand((1, n), generator=gen, device=device) + 0.5
    bias = torch.randn((1, n), generator=gen, device=device)
    return a_pl, b_pl, row, col, bias


def row_scales(row):
    """The per-row scale as (m, 1) values (row stride 1), one per-tensor
    value (1, 1), as qmm passes it, and that value expanded to (m, 1)
    (row stride 0)."""
    one = row[:1]
    return [row, one, one.expand(row.shape[0], 1)]


def misaligned(t, elems=1):
    """``t`` copied into a contiguous view ``elems`` elements past a 16-byte
    boundary (4 bytes for the int32 planes)."""
    import torch

    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[elems:elems + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def gemm_fns(mode):
    from repro_torch.kernels import bnn_matmul, tbn_matmul, tnn_matmul

    mod = {"tnn": tnn_matmul, "tbn": tbn_matmul, "bnn": bnn_matmul}[mode]
    return {v: getattr(mod, f"{mode}_matmul{v}") for v in
            ("_cuda", "_fused_cuda", "_torch", "_fused_torch")}


def popc_bound(popc: float, nbytes: float, max_sm_mhz: float):
    """(ms, "operations" | "bytes"): the least time for ``popc`` popcounts
    (16 per clock per SM on 132 SMs at the maximum SM clock) and
    ``nbytes`` of device memory traffic."""
    t_ops = popc / (SMS * POPC_PER_CLK_PER_SM * max_sm_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def diag_requests(dev):
    """One qmm request per mode and GEMM_GRID diagonal shape: (mode, x,
    packed weights), from numpy seed 0."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import GEMM_GRID
    from repro_torch.kernels import ops
    from repro_torch.kernels.modes import QuantMode

    rng = np.random.default_rng(0)
    requests = []
    for mode in MODES:
        for m, n, k in zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]):
            x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev)
            w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dev)
            requests.append((mode, x, ops.pack_weights(w, QuantMode(mode))))
    return requests, rng


def affine_requests(dev):
    """One u8 and one u4 qmm request per GEMM_GRID diagonal shape: (mode,
    x, packed weights), from numpy seed 1."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import GEMM_GRID
    from repro_torch.kernels import ops
    from repro_torch.kernels.modes import QuantMode

    rng = np.random.default_rng(1)
    requests = []
    for m, n, k in zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]):
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        for mode in ("int8", "int4"):
            requests.append((mode, x, ops.pack_weights(w, QuantMode(mode))))
    return requests


def gemm_rows(dev, gen, requests, cnn_shapes, max_sm_mhz, check=None):
    """Times of the GeMM rows — popcount fused and int32 per mode, dense
    per mode, u8 and u4 — through the public wrappers of the
    ``repro_torch`` on ``sys.path`` (this checkout's or, with ``--src``,
    another's):

    * at the GEMM_GRID diagonal (``requests``, and for u8/u4 the requests
      of :func:`affine_requests`, summed over the four shapes): events ms,
      device ms (torch.profiler), host us per call ((events - device) /
      calls), plain ms, bound, the library call (events and device ms:
      bf16 ``torch.matmul`` on the same +-1/0 values; for u8/u4 float64
      ``torch.matmul`` on the same integers, exact) and, fused and u8/u4,
      one ``qmm`` request (events);
    * at the CNN's im2col GeMM shapes (``cnn_shapes``: (mode, m, n, k);
      u8/u4 at all four, full-range operands from ``gen``): events ms,
      device ms, bound and the library call; for u8/u4 also
      ``torch._int_mm`` on signed int8 operands of the same shapes, B
      stored k-contiguous (events and device ms: cuBLAS's int8 path at its
      preferred layout, not the same function, so not the library time);
      with ``check`` (a Checker) the outputs there are held
      against the plain versions and dense against popcount.

    Every events time is taken before the first profiler session of the
    call, since a session leaves launches slower for the rest of the
    process.  The activation scale is passed as (m, 1) values, which
    every version of the wrappers takes; ``qmm`` passes what the entry
    point builds."""
    import torch
    from repro_torch.kernels import dense_fused, int4_matmul, int8_matmul, ops
    from repro_torch.kernels.modes import QuantMode

    a_keys = {"tnn": ("plus", "minus"), "tbn": ("plus", "minus"), "bnn": ("bits",)}
    b_keys = {"tnn": ("plus", "minus"), "tbn": ("bits",), "bnn": ("bits",)}
    cases = []          # the operands of each (mode, shape), diagonal then CNN
    for mode, x, qt in requests:
        m, k = x.shape
        n = qt.out_features
        xa = ops.quantize_activations(x, QuantMode(mode))
        cases.append({"mode": mode, "cnn": False, "x": x, "qt": qt, "k": k,
                      "a": [xa[kk] for kk in a_keys[mode]],
                      "b": [qt.payload[kk] for kk in b_keys[mode]],
                      "row": xa["scale"].reshape(1, 1).expand(m, 1).contiguous(),
                      "col": qt.scale.reshape(1, n)})
    for mode, m, n, k in cnn_shapes:
        a_pl, b_pl, row, col, _ = gemm_operands(mode, m, n, k, dev, gen)
        cases.append({"mode": mode, "cnn": True, "k": k, "a": a_pl, "b": b_pl, "row": row,
                      "col": col})
    for c in cases:
        av = dense_fused.unpack_values(c["a"], c["k"], c["mode"] != "bnn", torch.bfloat16)
        bv = dense_fused.unpack_values(c["b"], c["k"], c["mode"] == "tnn", torch.bfloat16).t()
        c["lib"] = lambda av=av, bv=bv: torch.matmul(av, bv)
    # u8/u4: the operands qmm builds at the diagonal, full-range ones at the
    # CNN shapes; the u4 operands nibble-packed along k
    for tag, qmode in (("u8", QuantMode.INT8), ("u4", QuantMode.INT4)):
        top = 256 if tag == "u8" else 16
        grids = []
        for mode, x, qt in affine_requests(dev):
            if mode == qmode.value:
                grids.append((False, x, qt, ops.quantize_activations(x, qmode)["q"].to(
                    torch.uint8), qt.payload["q"].to(torch.uint8)))
        for _, m, n, k in cnn_shapes:
            grids.append((True, None, None,
                          torch.randint(0, top, (m, k), generator=gen, device=dev,
                                        dtype=torch.uint8),
                          torch.randint(0, top, (k, n), generator=gen, device=dev,
                                        dtype=torch.uint8)))
        for cnn, x, qt, a8, b8 in grids:
            (m, k), n = a8.shape, b8.shape[1]
            ops_ = (int4_matmul.pack_nibbles_rows(a8), int4_matmul.pack_nibbles_cols(b8)) \
                if tag == "u4" else (a8, b8)
            ad, bd = a8.double(), b8.double()
            c = {"mode": tag, "cnn": cnn, "x": x, "qt": qt, "k": k, "ops": ops_,
                 "lib": lambda ad=ad, bd=bd: torch.matmul(ad, bd),
                 "nbytes": ops_[0].numel() + ops_[1].numel() + 4 * m * n, "mnk": [m, n, k]}
            if cnn:       # B stored k-contiguous, the layout cuBLAS's int8 path wants
                ai = (a8 ^ 0x80).view(torch.int8)
                bi = (b8 ^ 0x80).view(torch.int8).t().contiguous().t()
                c["int_mm"] = lambda ai=ai, bi=bi: torch._int_mm(ai, bi)
            cases.append(c)

    rows, jobs = [], []

    def new_row(name, qmm):
        return {"name": name, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0,
                "qmm_ms": 0.0 if qmm else None, "cnn_ms": 0.0, "cnn_device_ms": 0.0,
                "cnn_bound_ms": 0.0, "cnn_library_ms": 0.0, "cnn_library_device_ms": 0.0,
                "shapes_mnk": [], "cnn_shapes_mnk": []}

    for mode in MODES:
        qm, fn = QuantMode(mode), gemm_fns(mode)
        for dense, fused in ((False, True), (False, False), (True, True)):
            name = f"dense_gemm_{mode}" if dense else \
                f"lowbit_gemm_{mode}_{'fused' if fused else 'i32'}"
            if dense:
                def kfn(c, qm=qm):
                    return dense_fused.dense_matmul_fused_cuda(qm, c["a"], c["b"], c["k"],
                                                               c["row"], c["col"])

                def pfn(c, qm=qm):
                    return dense_fused.dense_matmul_fused_torch(qm, c["a"], c["b"], c["k"],
                                                                c["row"], c["col"])
            else:
                def kfn(c, f=fn["_fused_cuda" if fused else "_cuda"], fused=fused):
                    return f(*c["a"], *c["b"], c["k"], *((c["row"], c["col"]) if fused else ()))

                def pfn(c, f=fn["_fused_torch" if fused else "_torch"], fused=fused):
                    return f(*c["a"], *c["b"], c["k"], *((c["row"], c["col"]) if fused else ()))
            r = new_row(name, fused)
            by = {"": set(), "cnn_": set()}
            for c in cases:
                if c["mode"] != mode:
                    continue
                pre = "cnn_" if c["cnn"] else ""
                (m, kw), n = c["a"][0].shape, c["b"][0].shape[0]
                nbytes = 4 * kw * (m * len(c["a"]) + n * len(c["b"])) + 4 * m * n + \
                    (4 * (m + n) if fused else 0)
                b_ms, b_by = tc_bound(2 * m * n * c["k"], nbytes) if dense else \
                    popc_bound(m * n * kw * NPOPC[mode], nbytes, max_sm_mhz)
                r[pre + "bound_ms"] += b_ms
                by[pre].add(b_by)
                r[pre + "shapes_mnk"].append([m, n, c["k"]])
                qmm = None
                if fused and not c["cnn"]:
                    qmm = (lambda c=c, be="dense" if dense else "cuda":
                           ops.qmm(c["x"], c["qt"], backend=be))
                jobs.append({"r": r, "pre": pre, "c": c, "kfn": kfn, "pfn": pfn, "qmm": qmm,
                             "dense": dense,
                             "pattern": "dense_gemm_kernel" if dense else "lowbit_gemm_kernel"})
            r["bound_by"] = "operations" if "operations" in by[""] else "bytes"
            r["cnn_bound_by"] = "operations" if "operations" in by["cnn_"] else "bytes"
            rows.append(r)
    for tag, kfn_, pfn_ in (("u8", int8_matmul.int8_matmul_cuda, int8_matmul.int8_matmul_torch),
                            ("u4", int4_matmul.int4_matmul_cuda, int4_matmul.int4_matmul_torch)):
        r = new_row(f"affine_gemm_{tag}", True)
        r.update({"cnn_int_mm_ms": 0.0, "cnn_int_mm_device_ms": 0.0})
        by = {"": set(), "cnn_": set()}
        for c in cases:
            if c["mode"] != tag:
                continue
            pre = "cnn_" if c["cnn"] else ""
            m, n, k = c["mnk"]
            b_ms, b_by = tc_bound(2 * m * n * k, c["nbytes"])
            r[pre + "bound_ms"] += b_ms
            by[pre].add(b_by)
            r[pre + "shapes_mnk"].append([m, n, k])
            jobs.append({"r": r, "pre": pre, "c": c,
                         "kfn": lambda c, f=kfn_: f(*c["ops"]),
                         "pfn": lambda c, f=pfn_: f(*c["ops"]),
                         "qmm": None if c["cnn"] else
                         (lambda c=c: ops.qmm(c["x"], c["qt"], backend="cuda")),
                         "dense": False, "pattern": "affine_gemm_kernel"})
        r["bound_by"] = "operations" if "operations" in by[""] else "bytes"
        r["cnn_bound_by"] = "operations" if "operations" in by["cnn_"] else "bytes"
        rows.append(r)

    def add(r, key, v):      # a sum stays None once a term is None
        r[key] = None if v is None or r[key] is None else r[key] + v

    for j in jobs:                                              # events
        r, pre, c, kfn = j["r"], j["pre"], j["c"], j["kfn"]
        reps = 20 if c["cnn"] else 200
        add(r, pre + "ms", cuda_ms(lambda: kfn(c), reps=reps))
        add(r, pre + "library_ms", cuda_ms(c["lib"], reps=reps))
        if not c["cnn"]:
            add(r, "plain_ms", cuda_ms(lambda: j["pfn"](c), reps=10))
            if j["qmm"] is not None:
                add(r, "qmm_ms", cuda_ms(j["qmm"], reps=200))
        else:
            if "int_mm" in c:
                add(r, "cnn_int_mm_ms", cuda_ms(c["int_mm"], reps=reps))
            if check is not None:
                got = kfn(c)
                what = f"{r['name']} {c.get('mnk') or tuple(c['a'][0].shape)} (CNN im2col, " \
                       f"batch 256)"
                check.equal(r["name"], got, j["pfn"](c), what)
                if j["dense"] and not torch.equal(got, gemm_fns(c["mode"])["_fused_cuda"](
                        *c["a"], *c["b"], c["k"], c["row"], c["col"])):
                    raise AssertionError(f"{what}: dense != popcount kernel")
    for j in jobs:                                              # torch.profiler
        r, pre, c, kfn = j["r"], j["pre"], j["c"], j["kfn"]
        add(r, pre + "device_ms", kernel_device_ms(lambda: kfn(c), j["pattern"], reps=10))
        add(r, pre + "library_device_ms", kernel_device_ms(c["lib"], "", reps=10))
        if "int_mm" in c:
            add(r, "cnn_int_mm_device_ms", kernel_device_ms(c["int_mm"], "", reps=10))

    def ratio(a, b):
        return None if a is None or not b else a / b

    for r in rows:
        r["host_us_per_call"] = None if r["device_ms"] is None else \
            (r["ms"] - r["device_ms"]) / len(r["shapes_mnk"]) * 1e3
        r["ratio_lib_events"] = ratio(r["ms"], r["library_ms"])
        r["ratio_lib_device"] = ratio(r["device_ms"], r["library_device_ms"])
        r["cnn_ratio_bound_device"] = ratio(r["cnn_device_ms"], r["cnn_bound_ms"])
    return rows


def cnn_gemm_shapes(cfg, batch):
    """(m, n, k) of each low-bit conv's im2col GeMM in ``cfg``."""
    shapes, hw, c_in = [], cfg.img_size, cfg.c_in
    for spec in cfg.convs:
        hw_out = -(-hw // spec.stride)
        if spec.mode != "bf16":
            shapes.append((spec.mode, batch * hw_out * hw_out, spec.c_out,
                           spec.kernel * spec.kernel * c_in))
        hw = hw_out // 2 if spec.pool else hw_out
        c_in = spec.c_out
    return shapes


def lm_generate(torch, params, cfg, prompt, steps, time_it=False):
    """Greedy generation through the port's entry points: ``prefill`` on
    ``prompt`` (B, P) tokens, then ``steps`` ``decode_step`` calls, each
    fed the previous step's argmax.  Returns (the logits of every call,
    the generated tokens (B, steps + 1), prefill s, decode s); the times
    are on the host clock around synchronized work when ``time_it``."""
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.kvcache import init_caches

    lay = ShardLayout()
    b, p = prompt.shape
    caches = init_caches(cfg, lay, b, p + steps, device=prompt.device)
    if time_it:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, {"tokens": prompt}, caches, cfg, lay)
    if time_it:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, toks = [logits], [logits[:, -1].argmax(-1, keepdim=True)]
    for t in range(steps):
        logits, caches = model.decode_step(params, {"tokens": toks[-1]}, caches, p + t,
                                           cfg, lay)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    if time_it:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, torch.cat(toks, dim=1), t1 - t0, t2 - t1


def lm_equal(torch, got, want, what):
    """Every logits tensor and the tokens of two lm_generate runs equal."""
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        if not torch.equal(a, b):
            err = (a.double() - b.double()).abs().max().item()
            raise AssertionError(f"{what}: logits of call {i} differ (max abs err {err})")
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"{what}: generated tokens differ")


def projection_bytes(tree):
    """Bytes of the projection leaves of an LM tree — master weights or
    packed QTensors (payload + scales) — MoE experts and the shared
    expert, SSM in/out projections included."""
    from repro_torch.kernels.qtensor import QTensor

    total = 0
    for key, leaf in tree.items():
        if key not in PROJECTIONS:
            if isinstance(leaf, dict):
                total += projection_bytes(leaf)
            elif isinstance(leaf, list):
                total += sum(projection_bytes(t) for t in leaf)
        elif isinstance(leaf, QTensor):
            total += leaf.nbytes()
        elif isinstance(leaf, dict) and "w" in leaf:
            total += leaf["w"].numel() * leaf["w"].element_size()
    return total


def proj_shapes(cfg, m, m_expert):
    """(m, n, k) of every packed projection of one forward at ``m`` token
    rows (``m_expert`` rows per MoE expert)."""
    d, dh = cfg.d_model, cfg.head_dim_
    hd, kvd = cfg.num_heads * dh, cfg.num_kv_heads * dh

    def ffn(rows, f):
        return [(rows, f, d), (rows, f, d), (rows, d, f)]

    out = []
    for mixer, ffn_kind in cfg.layer_pattern:
        if mixer in ("A", "AL"):
            out += [(m, hd, d), (m, kvd, d), (m, kvd, d), (m, d, hd)]
        elif mixer == "M":
            din, g, n = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
            out += [(m, 2 * din + 2 * g * n + cfg.ssm_nheads, d), (m, d, din)]
        if ffn_kind == "D":
            out += ffn(m, cfg.d_ff)
        elif ffn_kind == "E":
            out += cfg.num_experts * ffn(m_expert, cfg.d_ff)
            if cfg.shared_expert_d_ff:
                out += ffn(m, cfg.shared_expert_d_ff)
    return out * cfg.num_periods


def tnn_gemms_per_forward(cfg) -> int:
    """Fused TNN GeMM launches of one forward of a model packed under tnn:
    one per projection, every MoE expert included (each runs on its
    capacity rows)."""
    return len(proj_shapes(cfg, 1, 1))


def kv_bytes_per_token(cfg, kv: str) -> int:
    """Cache bytes one token occupies in one attention layer: K and V and
    its position (bf16 slab: 2 bytes a value; tnn2: two bit planes of
    ceil(dh / 32) words a head and a float32 scale, for K and for V)."""
    dh, kvh = cfg.head_dim_, cfg.num_kv_heads
    if kv == "tnn2":
        return 2 * (kvh * 2 * -(-dh // 32) * 4 + 4) + 4
    return 2 * kvh * dh * 2 + 4


def lm_bounds(cfg, batch, prompt, steps, packed_bytes, kv="bf16"):
    """Least times of an LM run, from shapes: a decode step moves at least
    the packed projections, the bf16 LM head and its cache (the KV cache
    at its longest, or the SSM states read and written) at 3.35 TB/s; the
    prefill's popcount GeMMs do at least m * n * words * POPC per output
    word (16 per clock per SM, 132 SMs, 1980 MHz).  Returns (decode ms,
    prefill GeMM ms)."""
    from repro_torch.models.moe import moe_capacity

    attn = sum(m in ("A", "AL") for m, _ in cfg.layer_pattern) * cfg.num_periods
    ssm = sum(m == "M" for m, _ in cfg.layer_pattern) * cfg.num_periods
    cache = attn * batch * (prompt + steps) * kv_bytes_per_token(cfg, kv)
    if ssm:
        din, g, n = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
        state = cfg.ssm_nheads * n * cfg.ssm_headdim + (cfg.ssm_conv - 1) * (din + 2 * g * n)
        cache += 2 * ssm * batch * state * 4
    decode_s = (packed_bytes + cfg.d_model * cfg.vocab_size * 2 + cache) / HBM_BYTES_PER_S
    m_exp = batch * moe_capacity(cfg, prompt) if cfg.num_experts else 0
    popc = sum(m * n * -(-k // 32) * NPOPC["tnn"]
               for m, n, k in proj_shapes(cfg, batch * prompt, m_exp))
    return decode_s * 1e3, popc / (SMS * POPC_PER_CLK_PER_SM * 1980e6) * 1e3


def lm_phase(torch, dev):
    """Phase 7a-7c (see the module docstring); nothing here runs under
    torch.profiler.  Returns (the report, {kernel: launches on the LM
    path}, what phase 7d profiles)."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantLinear
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.packing import pack_lm_params

    t_phase = time.perf_counter()
    lay = ShardLayout()
    report, lm_launches = {}, {}
    gen = torch.Generator(device=dev).manual_seed(7)

    # -- 7a. TinyLlama-1.1B, full width and depth, tnn packed ---------------
    cfg = get_config(LM_ARCH, quant_policy="tnn")
    t0 = time.perf_counter()
    master = model.init_lm(gen, cfg, lay, dtype=cfg.dtype, device=dev)
    packed = pack_lm_params(master, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen,
                           device=dev)
    bf16_cfg = cfg.with_(quant_policy="bf16")
    with torch.no_grad():
        lm_generate(torch, packed, cfg, prompt[:, :8], 2)           # warm-up
        lm_generate(torch, master, bf16_cfg, prompt[:, :8], 2)
        _build.reset_launches()
        run = lm_generate(torch, packed, cfg, prompt, LM_STEPS, time_it=True)
        launches = _build.launches()
        forwards = 1 + LM_STEPS
        want = {LM_POLICY_KERNELS["tnn"]: tnn_gemms_per_forward(cfg) * forwards}
        if launches != want:
            raise AssertionError(f"LM path launches {launches}, expected {want} "
                                 f"(7 x {cfg.num_layers} per forward)")
        lm_launches.update(launches)
        vp = lay.pad_vocab(cfg.vocab_size)
        if run[0][0].shape != (LM_BATCH, 1, vp) or not all(
                torch.isfinite(lg).all() for lg in run[0]):
            raise AssertionError("LM logits of the wrong shape or not finite")
        bf16 = lm_generate(torch, master, bf16_cfg, prompt, LM_STEPS, time_it=True)
        for lg in bf16[0]:
            if not torch.isfinite(lg).all():
                raise AssertionError("bf16 LM logits not finite")
        t0 = time.perf_counter()
        lm_equal(torch, lm_generate(torch, packed, cfg.with_(quant_backend="torch"), prompt,
                                    LM_STEPS), run, "tnn packed: kernels vs plain")
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm_equal(torch, lm_generate(torch, master, cfg, prompt, LM_STEPS), run,
                 "tnn: packed vs QAT (master weights, quantized_matmul)")
        qat_s = time.perf_counter() - t0
    toks = LM_BATCH * LM_PROMPT
    report["7a"] = {
        "config": {"arch": LM_ARCH, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
                   "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
                   "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "dtype": str(cfg.dtype),
                   "batch": LM_BATCH, "prompt": LM_PROMPT, "decode_steps": LM_STEPS,
                   "weights": "random, torch.Generator seed 7 on the card"},
        "init_and_pack_s": init_s,
        "launches": launches,
        "tnn_prefill_tokens_per_s": toks / run[2], "tnn_prefill_ms": run[2] * 1e3,
        "tnn_decode_ms_per_token": run[3] * 1e3 / LM_STEPS,
        "bf16_prefill_tokens_per_s": toks / bf16[2], "bf16_prefill_ms": bf16[2] * 1e3,
        "bf16_decode_ms_per_token": bf16[3] * 1e3 / LM_STEPS,
        "plain_run": {"cut": "none: full depth, the same prompts and steps", "s": plain_s},
        "qat_run_s": qat_s,
        "kernel_equals_plain": True, "packed_equals_qat": True,
        "projection_bytes": {"tnn_packed": projection_bytes(packed),
                             "bf16": projection_bytes(master)},
    }
    pb = report["7a"]["projection_bytes"]
    pb["ratio_bf16_over_packed"] = pb["bf16"] / pb["tnn_packed"]
    report["7a"]["tnn_decode_bound_ms"], report["7a"]["tnn_prefill_gemm_bound_ms"] = \
        lm_bounds(cfg, LM_BATCH, LM_PROMPT, LM_STEPS, pb["tnn_packed"])
    report["7a"]["bf16_decode_bound_ms"] = lm_bounds(cfg, LM_BATCH, LM_PROMPT, LM_STEPS,
                                                     pb["bf16"])[0]
    log("[lm 7a] " + json.dumps(report["7a"]))

    # -- 7b. bnn, tnn_dense, int8 at full width, cut depth ------------------
    report["7b"] = {}
    for policy in ("bnn", "tnn_dense", "int8"):
        pcfg = get_config(LM_ARCH, quant_policy=policy, num_layers=LM_CUT_LAYERS)
        p_master = model.init_lm(gen, pcfg, lay, dtype=pcfg.dtype, device=dev)
        p_packed = pack_lm_params(p_master, pcfg)
        with torch.no_grad():
            _build.reset_launches()
            got = lm_generate(torch, p_packed, pcfg, prompt, LM_CUT_STEPS, time_it=True)
            launches = _build.launches()
            key = LM_POLICY_KERNELS[policy]
            want = {key: tnn_gemms_per_forward(pcfg) * (1 + LM_CUT_STEPS)}
            if launches != want:
                raise AssertionError(f"{policy}: launches {launches}, expected {want}")
            lm_launches[key] = lm_launches.get(key, 0) + launches[key]
            for lg in got[0]:
                if not torch.isfinite(lg).all():
                    raise AssertionError(f"{policy}: logits not finite")
            lm_equal(torch, got, lm_generate(torch, p_packed,
                                             pcfg.with_(quant_backend="torch"), prompt,
                                             LM_CUT_STEPS), f"{policy}: kernels vs plain")
        report["7b"][policy] = {"num_layers": LM_CUT_LAYERS, "decode_steps": LM_CUT_STEPS,
                                "launches": launches, "kernel_equals_plain": True,
                                "prefill_ms": got[2] * 1e3,
                                "decode_ms_per_token": got[3] * 1e3 / LM_CUT_STEPS}
        del p_master, p_packed
    log("[lm 7b] " + json.dumps(report["7b"]))

    # -- 7c. QuantLinear(2048, 5632, TNN) forward and backward --------------
    layer = QuantLinear(cfg.d_model, cfg.d_ff, mode=QuantMode.TNN)
    params = layer.init(gen, device=dev)
    x = (torch.randn((LM_PROMPT, cfg.d_model), generator=gen, device=dev) * 1.2)
    x.requires_grad_(True)
    w = params["w"].requires_grad_(True)
    y = layer.apply({"w": w}, x)
    if not torch.equal(y, ops.qmm(x.detach(), layer.pack(params))):
        raise AssertionError("QuantLinear forward != qmm(x, pack(w))")
    c = torch.randn(y.shape, generator=gen, device=dev)
    (y * c).sum().backward()
    xd, wd, cd = x.detach().double(), w.detach().double(), c.double()
    mask = xd.abs() <= 1
    gx_ref, gw_ref = (cd @ wd.t()) * mask, xd.t() @ cd
    # float32 summation bound: depth * 2**-24 * (|a| @ |b|)
    gx_bound = cfg.d_ff * 2.0 ** -24 * (cd.abs() @ wd.abs().t()) * mask
    gw_bound = LM_PROMPT * 2.0 ** -24 * (xd.abs().t() @ cd.abs())
    gx_err = (x.grad.double() - gx_ref).abs()
    gw_err = (w.grad.double() - gw_ref).abs()
    if (gx_err > gx_bound).any() or (gw_err > gw_bound).any():
        raise AssertionError(f"QuantLinear gradients past the float32 summation bound "
                             f"(max err gx {gx_err.max().item()}, gw {gw_err.max().item()})")
    if (x.grad[~mask] != 0).any():
        raise AssertionError("QuantLinear gx not masked where |x| > 1")
    report["7c"] = {"shape": [LM_PROMPT, cfg.d_model, cfg.d_ff], "forward_equals_qmm": True,
                    "gx_max_abs_err": gx_err.max().item(),
                    "gw_max_abs_err": gw_err.max().item(),
                    "gx_max_err_over_bound": (gx_err / gx_bound.clamp(min=1e-30)).max().item(),
                    "gw_max_err_over_bound": (gw_err / gw_bound.clamp(min=1e-30)).max().item(),
                    "masked_share": float((~mask).double().mean().item()),
                    "bound": "float32 summation bound depth * 2**-24 * (|a| @ |b|), "
                             "against float64"}
    log("[lm 7c] " + json.dumps(report["7c"]))
    del master
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    return report, lm_launches, (packed, cfg, prompt, run)


def lm_profile(torch, packed, cfg, prompt, prefill_ms, decode_ms):
    """Phase 7d: torch.profiler over one prefill and over one decode step
    of the tnn packed model (two sessions: a session over the whole run
    records ~10**5 kernels and takes minutes to read back); busy share =
    device kernel time over the unprofiled host time of 7a."""
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.kvcache import init_caches

    lay = ShardLayout()
    b, p = prompt.shape
    caches = init_caches(cfg, lay, b, p + 1, device=prompt.device)
    out = {}
    with torch.no_grad():
        for name, fn, host_ms in (
                ("prefill", lambda: model.prefill(packed, {"tokens": prompt}, caches, cfg,
                                                  lay), prefill_ms),
                ("decode_step", lambda: model.decode_step(packed, {"tokens": prompt[:, -1:]},
                                                          caches, p, cfg, lay), decode_ms)):
            rows, prof_ms = profiled(fn)
            dev_ms = sum(r[1] for r in rows)
            gemm_ms = sum(ms for name_, ms, _ in rows if "lowbit_gemm_kernel" in name_)
            out[name] = {"device_kernel_ms": dev_ms, "host_ms_profiled": prof_ms,
                         "host_ms_unprofiled": host_ms, "device_busy_share": dev_ms / host_ms,
                         "gemm_kernel_ms": gemm_ms, "pytorch_kernels_ms": dev_ms - gemm_ms,
                         "kernels": sum(r[2] for r in rows),
                         "top": [[n[:80], ms, calls] for n, ms, calls in rows[:10]]}
    return out


def paged_generate(torch, params, cfg, prompt, steps, time_it=False, chunk=None):
    """Greedy generation against a paged cache: the prompt in chunks of
    ``chunk`` (default PAGED_CHUNK) tokens (pages backed through ``EntryPager`` and pushed by
    ``sync_page_tables`` before each chunk), then ``steps`` decode steps.
    Returns (the logits of the last prompt position and of every decode
    step, the tokens (B, steps + 1), prefill s, decode s, caches,
    pagers)."""
    from repro_torch.models import ShardLayout, model
    from repro_torch.models import paged_kvcache as paged
    from repro_torch.models.kvcache import init_caches

    lay = ShardLayout()
    b, p = prompt.shape
    chunk = chunk or PAGED_CHUNK
    caches = init_caches(cfg, lay, b, p + steps, page_size=PAGED_PAGE,
                         prefill_chunk=chunk, device=prompt.device)
    pagers = paged.make_pagers(caches, b)

    def back(hi):
        for slot in range(b):
            for pg in pagers:
                pg.ensure(slot, hi)
        return paged.sync_page_tables(caches, pagers)

    if time_it:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, p, chunk):
        n = min(chunk, p - start)
        toks = torch.zeros((b, chunk), dtype=prompt.dtype, device=prompt.device)
        toks[:, :n] = prompt[:, start:start + n]
        caches = back(start + n)
        st = torch.tensor([[start, n]] * b, dtype=torch.int32, device=prompt.device)
        logits, caches = model.decode_step(params, {"tokens": toks}, caches, st, cfg, lay)
    logits = logits[:, n - 1:n]
    if time_it:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, toks = [logits], [logits[:, -1].argmax(-1, keepdim=True)]
    for t in range(steps):
        caches = back(p + t + 1)
        logits, caches = model.decode_step(params, {"tokens": toks[-1]}, caches, p + t, cfg,
                                           lay)
        out.append(logits)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    if time_it:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, torch.cat(toks, dim=1), t1 - t0, t2 - t1, caches, pagers


def phase8(torch, dev, lm_state):
    """Phase 8a-8d (see the module docstring); nothing here runs under
    torch.profiler.  ``lm_state`` is phase 7a's (packed TinyLlama, its
    config, the prompt, its run).  Returns (the report, {kernel:
    launches})."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import ShardLayout, model
    from repro_torch.models import paged_kvcache as paged
    from repro_torch.models.kvcache import init_caches
    from repro_torch.models.packing import pack_lm_params

    t_phase = time.perf_counter()
    lay = ShardLayout()
    report, launches8 = {}, {}
    gen = torch.Generator(device=dev).manual_seed(8)
    key = LM_POLICY_KERNELS["tnn"]

    def add(launches):
        for k, v in launches.items():
            launches8[k] = launches8.get(k, 0) + v

    def arch_config(cfg, batch, prompt, steps):
        return {"arch": cfg.name, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
                "vocab_size": cfg.vocab_size, "dtype": str(cfg.dtype), "batch": batch,
                "prompt": prompt, "decode_steps": steps,
                "weights": "random, torch.Generator seed 8 on the card"}

    def full_run(name, arch, prompt_len, steps):
        """Build ``arch`` at full size, pack it under tnn, run it, hold it to
        the plain and QAT runs; returns (report, master, packed, cfg,
        prompt)."""
        cfg = get_config(arch, quant_policy="tnn")
        t0 = time.perf_counter()
        master = model.init_lm(gen, cfg, lay, dtype=cfg.dtype, device=dev)
        packed = pack_lm_params(master, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt_len), generator=gen,
                               device=dev)
        with torch.no_grad():
            lm_generate(torch, packed, cfg, prompt[:, :8], 1)            # warm-up
            _build.reset_launches()
            run = lm_generate(torch, packed, cfg, prompt, steps, time_it=True)
            launches = _build.launches()
            per_forward = tnn_gemms_per_forward(cfg)
            want = {key: per_forward * (1 + steps)}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches}, expected {want} "
                                     f"({per_forward} per forward)")
            add(launches)
            for lg in run[0]:
                if lg.shape != (LM_BATCH, 1, lay.pad_vocab(cfg.vocab_size)) or \
                        not torch.isfinite(lg).all():
                    raise AssertionError(f"{name}: logits of the wrong shape or not finite")
            t0 = time.perf_counter()
            lm_equal(torch, lm_generate(torch, packed, cfg.with_(quant_backend="torch"),
                                        prompt, steps), run, f"{name}: kernels vs plain")
            plain_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lm_equal(torch, lm_generate(torch, master, cfg, prompt, steps), run,
                     f"{name}: packed vs QAT (master weights, quantized_matmul)")
            qat_s = time.perf_counter() - t0
        pb = projection_bytes(packed)
        decode_bound, prefill_bound = lm_bounds(cfg, LM_BATCH, prompt_len, steps, pb)
        rep = {"config": arch_config(cfg, LM_BATCH, prompt_len, steps),
               "init_and_pack_s": init_s, "launches": launches,
               "tnn_gemms_per_forward": per_forward,
               "prefill_tokens_per_s": LM_BATCH * prompt_len / run[2],
               "prefill_ms": run[2] * 1e3, "decode_ms_per_token": run[3] * 1e3 / steps,
               "decode_bound_ms": decode_bound, "prefill_gemm_bound_ms": prefill_bound,
               "kernel_equals_plain": True, "packed_equals_qat": True,
               "plain_run": {"cut": "none: the same prompts and steps", "s": plain_s},
               "qat_run_s": qat_s,
               "projection_bytes": {"tnn_packed": pb, "bf16": projection_bytes(master)}}
        return rep, master, packed, cfg, prompt

    # -- 8a. Qwen2-MoE-A2.7B ----------------------------------------------
    rep, master, packed, cfg, prompt = full_run("8a moe", MOE_ARCH, LM_PROMPT, MOE_STEPS)
    with torch.no_grad():
        aux = model.forward(packed, {"tokens": prompt}, cfg, lay)[1]
    from repro_torch.models.moe import moe_capacity
    rep["config"].update(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                         d_ff=cfg.d_ff, shared_expert_d_ff=cfg.shared_expert_d_ff,
                         capacity_prefill=moe_capacity(cfg, LM_PROMPT),
                         capacity_decode=moe_capacity(cfg, 1))
    rep["aux_loss"] = aux.item()
    report["8a"] = rep
    log("[lm 8a] " + json.dumps(rep))
    del master, packed
    torch.cuda.empty_cache()

    # -- 8b. Mamba2-1.3B ---------------------------------------------------
    rep, master, packed, cfg, _ = full_run("8b ssm", SSM_ARCH, SSM_PROMPT, SSM_STEPS)
    rep["config"].update(d_inner=cfg.ssm_d_inner, ssm_heads=cfg.ssm_nheads,
                         ssm_state=cfg.ssm_state, ssm_chunk=cfg.ssm_chunk,
                         chunks_per_prompt=SSM_PROMPT // cfg.ssm_chunk)
    report["8b"] = rep
    log("[lm 8b] " + json.dumps(rep))
    del master, packed
    torch.cuda.empty_cache()

    # -- 8c. TinyLlama-1.1B on the paged ternary cache ---------------------
    packed, cfg7, prompt, run7 = lm_state
    cfg = cfg7.with_(kv_cache_dtype="tnn2")
    forwards = -(-LM_PROMPT // PAGED_CHUNK) + LM_STEPS
    with torch.no_grad():
        paged_generate(torch, packed, cfg, prompt[:, :8], 1)              # warm-up
        _build.reset_launches()
        run = paged_generate(torch, packed, cfg, prompt, LM_STEPS, time_it=True)
        launches = _build.launches()
        want = {key: tnn_gemms_per_forward(cfg) * forwards}
        if launches != want:
            raise AssertionError(f"8c paged: launches {launches}, expected {want}")
        add(launches)
        for lg in run[0]:
            if not torch.isfinite(lg).all():
                raise AssertionError("8c paged: logits not finite")
        lm_equal(torch, paged_generate(torch, packed, cfg.with_(quant_backend="torch"), prompt,
                                       LM_STEPS)[:2], run[:2], "8c tnn2: kernels vs plain")
        ocfg = cfg7.with_(kv_cache_dtype="tnn2-oracle")
        oracle = paged_generate(torch, packed, ocfg, prompt, LM_STEPS, time_it=True)
        oracle1 = paged_generate(torch, packed, ocfg, prompt, LM_STEPS, chunk=LM_PROMPT)

    def against_7a(o):
        """Greedy tokens agreeing with 7a's bf16 slab run, and the max abs
        logit difference over the calls whose inputs still agree."""
        same = (o[1] == run7[1]).all(dim=0)
        n_cmp = min(int(same.long().cumprod(0).sum().item()) + 1, len(run7[0]))
        return {"tokens_agreeing": (o[1] == run7[1]).double().mean().item(),
                "calls_compared": n_cmp,
                "max_abs_logit_diff": max((a - b).abs().max().item()
                                          for a, b in zip(o[0][:n_cmp], run7[0][:n_cmp]))}

    caches, pagers = run[4], run[5]
    tnn2_bytes = paged.tree_nbytes(caches)
    slab_bytes = paged.tree_nbytes(init_caches(cfg7, lay, LM_BATCH, LM_PROMPT + LM_STEPS,
                                               device=dev))
    high = [pg.stats()["high_water"] for pg in pagers]
    for entry, pg in zip(caches, pagers):
        for slot in range(LM_BATCH):
            paged.reset_pages(entry, pg.release(slot))
        if pg.alloc.n_used or pg.alloc.n_free != pg.alloc.n_pages - 1:
            raise AssertionError(f"8c: the page allocator does not balance: {pg.stats()}")
    if (caches[0]["pos"] != paged.INVALID_POS).any():
        raise AssertionError("8c: released pages keep positions")
    pb = projection_bytes(packed)
    dec_bound, _ = lm_bounds(cfg, LM_BATCH, LM_PROMPT, LM_STEPS, pb, kv="tnn2")
    report["8c"] = {
        "config": {"arch": cfg.name, "num_layers": cfg.num_layers, "kv_cache_dtype": "tnn2",
                   "batch": LM_BATCH, "prompt": LM_PROMPT, "prefill_chunk": PAGED_CHUNK,
                   "page": PAGED_PAGE, "decode_steps": LM_STEPS,
                   "weights": "phase 7a's (packed under tnn)"},
        "launches": launches, "forwards": forwards, "kernel_equals_plain": True,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / run[2], "prefill_ms": run[2] * 1e3,
        "decode_ms_per_token": run[3] * 1e3 / LM_STEPS, "decode_bound_ms": dec_bound,
        "bf16_slab_decode_bound_ms": lm_bounds(cfg7, LM_BATCH, LM_PROMPT, LM_STEPS, pb)[0],
        "oracle_vs_7a_bf16_slab": {
            **against_7a(oracle), "oracle_decode_ms_per_token": oracle[3] * 1e3 / LM_STEPS,
            "note": "a prefill chunk quantizes its activations with its own per-tensor "
                    "statistics, so a chunked tnn prefill is not 7a's full one",
            "prompt_as_one_chunk": against_7a(oracle1)},
        "cache_bytes": {"bf16_slab": slab_bytes, "tnn2": tnn2_bytes,
                        "ratio": slab_bytes / tnn2_bytes,
                        "per_token_layer_bf16": kv_bytes_per_token(cfg, "bf16"),
                        "per_token_layer_tnn2": kv_bytes_per_token(cfg, "tnn2"),
                        "ratio_per_token": kv_bytes_per_token(cfg, "bf16")
                        / kv_bytes_per_token(cfg, "tnn2")},
        "pages_high_water": high, "allocator_balanced_after_release": True}
    log("[lm 8c] " + json.dumps(report["8c"]))

    # -- 8d. the indexed policies, full width, cut depth ---------------------
    report["8d"] = {}
    masters = {}
    for policy, mode in INDEXED_POLICIES.items():
        pcfg = get_config(LM_ARCH, quant_policy=policy, num_layers=LM_CUT_LAYERS)
        if mode not in masters:
            mcfg = pcfg.with_(quant_policy=mode)
            masters[mode] = pack_lm_params(
                model.init_lm(gen, mcfg, lay, dtype=mcfg.dtype, device=dev), mcfg)
        params = masters[mode]
        with torch.no_grad():
            _build.reset_launches()
            got = lm_generate(torch, params, pcfg, prompt, LM_CUT_STEPS, time_it=True)
            launches = _build.launches()
            attn = 4 * LM_CUT_LAYERS * (1 + LM_CUT_STEPS)
            want = {key: attn} if policy == "tnn_mixed" else {}
            if launches != want:
                raise AssertionError(f"8d {policy}: launches {launches}, expected {want}")
            add(launches)
            ref = lm_generate(torch, params, pcfg.with_(quant_policy=mode), prompt,
                              LM_CUT_STEPS, time_it=True)
            lm_equal(torch, got, ref, f"8d {policy}: indexed vs popcount ({mode})")
        report["8d"][policy] = {"num_layers": LM_CUT_LAYERS, "decode_steps": LM_CUT_STEPS,
                                "launches": launches, "equals_popcount": mode,
                                "prefill_ms": got[2] * 1e3,
                                "decode_ms_per_token": got[3] * 1e3 / LM_CUT_STEPS,
                                "popcount_prefill_ms": ref[2] * 1e3,
                                "popcount_decode_ms_per_token": ref[3] * 1e3 / LM_CUT_STEPS}
    del masters
    torch.cuda.empty_cache()
    log("[lm 8d] " + json.dumps(report["8d"]))
    report["phase_s"] = time.perf_counter() - t_phase
    return report, launches8


def device_and_build(torch, _build):
    """Phases 1 and 2: the card (name, count, power limit, maximum SM
    clock) and the build of every csrc library.  Returns (kind, the
    nvidia-smi name and power limit line, max SM MHz)."""
    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    clocks = nvidia_smi("clocks.sm,clocks.max.sm")
    max_sm_mhz = float(re.findall(r"([\d.]+)\s*MHz", clocks)[-1])
    log(f"[device] {kind}; count={torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; SM clock now/max: {clocks}")
    log(card)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if re.search(r"Compiling entry|registers|spill|smem", line):
                log(f"[ptxas {name}] {line.strip()}")
    return kind, card, max_sm_mhz


def gemm_times(torch, src: str) -> int:
    """``--gemm-times``: phases 1 and 2, then the GeMM rows of phase 6
    (:func:`gemm_rows`) for the package under ``src``, as one JSON line
    ``[gemm-times] {...}``."""
    try:
        from repro_torch.configs.paper_cnn import PAPER_CNN
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: no repro_torch package under {src} ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, max_sm_mhz = device_and_build(torch, _build)
    gen = torch.Generator(device=dev).manual_seed(0)
    requests, _ = diag_requests(dev)
    rows = gemm_rows(dev, gen, requests, cnn_gemm_shapes(PAPER_CNN, BATCH), max_sm_mhz)
    log("[gemm-times] " + json.dumps({"src": src, "max_sm_mhz": max_sm_mhz, "rows": rows,
                                      "seconds": time.perf_counter() - t_start}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gemm-times", action="store_true",
                        help="run only the device and build phases and the GeMM rows of "
                             "phase 6")
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="with --gemm-times: the directory that holds the repro_torch "
                             "package to time (default: this checkout's src)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if args.gemm_times:
        sys.path.insert(0, args.src)
        return gemm_times(torch, args.src)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.cnn import PaperCNN
        from repro_torch.configs.paper_cnn import GEMM_GRID, PAPER_CNN, PAPER_CNN_SMOKE
        from repro_torch.core import conv as tconv
        from repro_torch.kernels import (_build, conv_fused, dense_fused, int4_matmul,
                                         int8_matmul, ops)
        from repro_torch.kernels._matmul_common import AFFINE_TILES, DENSE_TILES, gemm_tile
        from repro_torch.kernels.modes import QuantMode
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, max_sm_mhz = device_and_build(torch, _build)

    check = Checker()
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 3. GeMM kernel vs plain -------------------------------------------
    t0 = time.perf_counter()
    grid = list(itertools.product(GEMM_GRID["height"], GEMM_GRID["width"],
                                  GEMM_GRID["depth"]))
    im2col = [(m, n, k) for _, m, n, k in cnn_gemm_shapes(PAPER_CNN, 8)]
    shapes = grid + GEMM_EXTRA + im2col
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {"popcount": sorted({gemm_tile(m, n, sms) for m, n, _ in shapes}),
             "dense": sorted({gemm_tile(m, n, sms, DENSE_TILES) for m, n, _ in shapes})}
    for mode in MODES:
        fn = gemm_fns(mode)
        for m, n, k in shapes:
            a_pl, b_pl, row, col, bias = gemm_operands(mode, m, n, k, dev, gen)
            ops_ = a_pl + b_pl
            what = f"gemm {mode} {m}x{n}x{k}"
            check.equal(f"lowbit_gemm_{mode}_i32", fn["_cuda"](*ops_, k),
                        fn["_torch"](*ops_, k), what + " int32")
            for r in row_scales(row):
                for b in (None, bias):
                    check.equal(f"lowbit_gemm_{mode}_fused",
                                fn["_fused_cuda"](*ops_, k, r, col, b),
                                fn["_fused_torch"](*ops_, k, r, col, b),
                                f"{what} fused row {tuple(r.shape)} stride {r.stride()} "
                                f"bias={b is not None}")
        a_pl, b_pl, row, col, bias = gemm_operands(mode, *MISALIGNED, dev, gen)
        check.equal(f"lowbit_gemm_{mode}_fused",
                    fn["_fused_cuda"](*map(misaligned, a_pl + b_pl), MISALIGNED[2], row, col,
                                      bias),
                    fn["_fused_torch"](*a_pl, *b_pl, MISALIGNED[2], row, col, bias),
                    f"gemm {mode} {MISALIGNED} planes at a 4-byte offset")
    torch.cuda.synchronize()
    log(f"[gemm] {len(shapes)} shapes (tiles {tiles}) x 3 modes x (int32, fused x row "
        f"scale (m, 1) / one value / one value expanded x no bias / bias), planes at a "
        f"4-byte offset: kernel == plain ({time.perf_counter() - t0:.1f} s)")

    # -- 4. conv kernel vs plain -------------------------------------------
    t0 = time.perf_counter()
    geoms, hw, c_in = [], PAPER_CNN.img_size, PAPER_CNN.c_in
    for spec in PAPER_CNN.convs:
        if spec.mode != "bf16":
            geoms.append(((8, hw, hw, c_in), (spec.kernel, spec.kernel, c_in, spec.c_out),
                          spec.stride, "SAME"))
        hw = hw // 2 if spec.pool else hw
        c_in = spec.c_out
    geoms += [((8, 16, 16, 8), (3, 3, 8, 64), 1, "SAME"),        # positional planes
              ((8, 17, 17, 64), (3, 3, 64, 128), 2, "VALID"),
              ((2, 6, 6, 480), (3, 3, 480, 24), 1, "SAME"),      # A streamed (ternary)
              ((1, 4, 5, 1000), (3, 3, 1000, 9), 1, "SAME")]     # A streamed (BNN)
    for mode in MODES:
        qm = QuantMode(mode)
        for xs, fs, stride, padding in geoms:
            x = torch.randn(xs, generator=gen, device=dev)
            f = torch.randn(fs, generator=gen, device=dev)
            bias = torch.randn((fs[-1],), generator=gen, device=dev)
            kh, kw_ = fs[:2]
            stats = conv_fused.conv_act_stats(x, qm, kh, kw_, stride, padding)
            got = conv_fused.conv_pack_cuda(qm, x, kh, kw_, stride, padding, stats)
            want = conv_fused.conv_pack_torch(qm, x, kh, kw_, stride, padding, stats)
            if len(got) != len(want):
                raise AssertionError(f"conv pack {mode} x{xs}: {len(got)} planes")
            for g_, w_ in zip(got, want):
                check.equal(f"conv_pack_{mode}", g_, w_,
                            f"conv pack {mode} x{xs} k{kh} s{stride} {padding}")
            for b in (None, bias):
                qt = tconv.pack_conv_filters(f, QuantMode(mode), bias=b)
                check.equal(f"lowbit_conv_{mode}",
                            ops.qconv(x, qt, stride=stride, padding=padding, backend="cuda"),
                            ops.qconv(x, qt, stride=stride, padding=padding, backend="torch"),
                            f"conv {mode} x{xs} f{fs} s{stride} {padding} "
                            f"bias={b is not None}")
    torch.cuda.synchronize()
    log(f"[conv] {len(geoms)} geometries x 3 modes: pack kernel == plain; conv (pack + "
        f"conv) x (no bias, bias) == plain ({time.perf_counter() - t0:.1f} s)")

    # -- 4b. dense and affine kernels vs plain ------------------------------
    t0 = time.perf_counter()
    for mode in MODES:
        qm, popcount = QuantMode(mode), gemm_fns(mode)["_fused_cuda"]
        for m, n, k in shapes:
            a_pl, b_pl, row, col, bias = gemm_operands(mode, m, n, k, dev, gen)
            for r in row_scales(row)[:2]:
                for b in (None, bias):
                    got = dense_fused.dense_matmul_fused_cuda(qm, a_pl, b_pl, k, r, col, b)
                    what = (f"dense gemm {mode} {m}x{n}x{k} row {tuple(r.shape)} "
                            f"bias={b is not None}")
                    check.equal(f"dense_gemm_{mode}", got, dense_fused.dense_matmul_fused_torch(
                        qm, a_pl, b_pl, k, r, col, b), what)
                    if not torch.equal(got, popcount(*a_pl, *b_pl, k, r, col, b)):
                        raise AssertionError(f"{what}: dense != popcount kernel")
        a_pl, b_pl, row, col, bias = gemm_operands(mode, *MISALIGNED, dev, gen)
        check.equal(f"dense_gemm_{mode}", dense_fused.dense_matmul_fused_cuda(
            qm, [misaligned(p) for p in a_pl], [misaligned(p) for p in b_pl], MISALIGNED[2],
            row, col, bias), dense_fused.dense_matmul_fused_torch(
            qm, a_pl, b_pl, MISALIGNED[2], row, col, bias),
            f"dense gemm {mode} {MISALIGNED} planes at a 4-byte offset")
        for xs, fs, stride, padding in geoms:
            x = torch.randn(xs, generator=gen, device=dev)
            f = torch.randn(fs, generator=gen, device=dev)
            bias = torch.randn((fs[-1],), generator=gen, device=dev)
            for b in (None, bias):
                qt = tconv.pack_conv_filters(f, qm, bias=b)
                kh, kw_, _, cout = fs
                args = (qm, x, conv_fused.conv_weight_planes(qt), qt.geometry, stride,
                        padding, conv_fused.conv_act_stats(x, qm, kh, kw_, stride, padding),
                        qt.scale.reshape(1, cout), None if b is None else b.reshape(1, cout))
                got = dense_fused.dense_conv_fused_cuda(*args)
                what = f"dense conv {mode} x{xs} f{fs} s{stride} {padding} bias={b is not None}"
                check.equal(f"dense_conv_{mode}", got, dense_fused.dense_conv_fused_torch(*args),
                            what)
                if not torch.equal(got, ops.qconv(x, qt, stride=stride, padding=padding)):
                    raise AssertionError(f"{what}: dense != popcount conv kernel")
    affine_shapes = grid + AFFINE_EXTRA + im2col
    affine_tiles = sorted({gemm_tile(m, n, sms, AFFINE_TILES) for m, n, _ in affine_shapes})
    (mm, nn, kk), offsets = AFFINE_MISALIGNED
    for (m, n, k), off in [(s_, 0) for s_ in affine_shapes] + [((mm, nn, kk), o) for o in offsets]:
        a8 = torch.randint(0, 256, (m, k), generator=gen, device=dev, dtype=torch.uint8)
        b8 = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        pa = int4_matmul.pack_nibbles_rows(a8 >> 4)
        pb = int4_matmul.pack_nibbles_cols(b8 & 0xF)
        want8 = int8_matmul.int8_matmul_torch(a8, b8)
        want4 = int4_matmul.int4_matmul_torch(pa, pb)
        if off:
            a8, b8, pa, pb = (misaligned(t, off) for t in (a8, b8, pa, pb))
        what = f"{m}x{n}x{k}" + (f", operands {off} bytes past 16" if off else "")
        check.equal("affine_gemm_u8", int8_matmul.int8_matmul_cuda(a8, b8), want8, f"u8 {what}")
        check.equal("affine_gemm_u4", int4_matmul.int4_matmul_cuda(pa, pb), want4, f"u4 {what}")
    torch.cuda.synchronize()
    log(f"[dense] gemm {len(shapes)} shapes (x row scale (m, 1) / one value) and planes at a "
        f"4-byte offset, conv {len(geoms)} geometries, x 3 modes x (no bias, bias): kernel "
        f"== plain == popcount kernel; [affine] u8 and u4 at "
        f"{len(affine_shapes)} shapes (tiles {affine_tiles}) and operands {offsets} bytes "
        f"past a 16-byte boundary, full-range operands: kernel == plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 5. the main path --------------------------------------------------
    requests, rng = diag_requests(dev)
    model = PaperCNN(PAPER_CNN, seed=0, device=dev)
    images = [torch.from_numpy(rng.standard_normal(
        (BATCH, PAPER_CNN.img_size, PAPER_CNN.img_size, PAPER_CNN.c_in),
        dtype=np.float32)).to(dev) for _ in range(BATCHES)]
    layer_inputs = {}
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, i=i: layer_inputs.__setitem__(i, args[0]))
        for i, layer in enumerate(model.layers)]
    torch.cuda.synchronize()

    _build.reset_launches()
    gemm_out = [(ops.qmm(x, qt), ops.packed_matmul(
        ops.quantize_activations(x, qt.mode), qt)) for _, x, qt in requests]
    logits = [model(images[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits += [model(img) for img in images[1:]]
    torch.cuda.synchronize()
    cnn_s = time.perf_counter() - t0
    launches = _build.launches()

    for h in hooks:
        h.remove()
    log(f"[main] launches: {json.dumps(launches, sort_keys=True)}")
    expected = [f"lowbit_gemm_{m}_{v}" for m in MODES for v in ("fused", "i32")] + \
               [f"lowbit_conv_{m}" for m in MODES] + [f"conv_pack_{m}" for m in MODES]
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    for m in MODES:
        if launches[f"conv_pack_{m}"] != launches[f"lowbit_conv_{m}"]:
            raise AssertionError(f"main path: {launches[f'conv_pack_{m}']} packs for "
                                 f"{launches[f'lowbit_conv_{m}']} {m} convs")
    for y, acc in gemm_out:
        if not torch.isfinite(y).all():
            raise AssertionError("qmm request gave non-finite output")
    for out in logits:
        if out.shape != (BATCH, PAPER_CNN.num_classes) or not torch.isfinite(out).all():
            raise AssertionError(f"CNN logits {tuple(out.shape)} not finite")
    log(f"[main] PaperCNN(PAPER_CNN) batch {BATCH}: "
        f"{(BATCHES - 1) * BATCH / cnn_s:.1f} images/s over {BATCHES - 1} batches "
        f"after warm-up ({cnn_s * 1e3 / (BATCHES - 1):.3f} ms/batch, host clock)")

    # the same requests and batch through the plain versions, layer by layer
    for (mode, x, qt), (y, acc) in zip(requests, gemm_out):
        check.equal(f"lowbit_gemm_{mode}_fused", y, ops.qmm(x, qt, backend="torch"),
                    f"main-path qmm {mode} {tuple(x.shape)}")
        check.equal(f"lowbit_gemm_{mode}_i32", acc, ops.packed_matmul(
            ops.quantize_activations(x, qt.mode), qt, backend="torch"),
            f"main-path packed_matmul {mode} {tuple(x.shape)}")
    plain = PaperCNN(PAPER_CNN, seed=0, device=dev, backend="torch")
    h_k = h_p = images[-1]
    for i, (spec, lk, lp) in enumerate(zip(PAPER_CNN.convs, model.layers, plain.layers)):
        h_k, h_p = lk(h_k), lp(h_p)
        if spec.mode != "bf16":
            check.equal(f"lowbit_conv_{spec.mode}", h_k, h_p, f"main-path layer {i}")
            oracle = tconv.conv2d_packed(layer_inputs[i], lk.packed, stride=spec.stride,
                                         fused=False)
            if not torch.equal(h_k, oracle):
                raise AssertionError(f"layer {i}: conv kernel != im2col + qmm oracle")
        h_k, h_p = torch.relu(h_k), torch.relu(h_p)
        if spec.pool:
            b, hh, ww, c = h_k.shape
            h_k = h_k.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
            h_p = h_p.reshape(b, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    if not torch.equal(logits[-1], plain(images[-1])):
        raise AssertionError("CNN logits differ from the plain run")
    small = PaperCNN(PAPER_CNN_SMOKE, seed=1, device=dev)
    small_cpu = PaperCNN(PAPER_CNN_SMOKE, seed=1, device="cpu")
    xs = torch.from_numpy(rng.standard_normal((4, 8, 8, 3), dtype=np.float32))
    err = (small(xs.to(dev)).cpu() - small_cpu(xs)).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"small CNN on the card vs the CPU: max abs err {err}")
    log(f"[main] plain run equal layer by layer; conv == im2col+qmm oracle; small CNN "
        f"card vs CPU max abs err {err:.3g}")

    # -- 5b. the second main path: f32/u8/u4 qmm, the dense backend ----------
    diag = list(zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]))
    requests2 = []
    for m, n, k in diag:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        for mode in ("f32", "int8", "int4"):
            requests2.append((mode, None, x, ops.pack_weights(w, QuantMode(mode))))
        for mode in MODES:
            requests2.append((mode, "dense", x, ops.pack_weights(w, QuantMode(mode))))
    dense_model = PaperCNN(PAPER_CNN, seed=0, device=dev, backend="dense")
    torch.cuda.synchronize()

    _build.reset_launches()
    out2 = [ops.qmm(x, qt, backend=be) for _, be, x, qt in requests2]
    dense_logits = [dense_model(images[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_logits += [dense_model(img) for img in images[1:]]
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    launches2 = _build.launches()

    log(f"[main2] launches: {json.dumps(launches2, sort_keys=True)}")
    expected2 = [f"dense_gemm_{m}" for m in MODES] + [f"dense_conv_{m}" for m in MODES] + \
                [f"conv_pack_{m}" for m in MODES] + ["affine_gemm_u8", "affine_gemm_u4"]
    missing = [k for k in expected2 if launches2.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"second main path never launched {missing}")
    for m in MODES:
        if launches2[f"conv_pack_{m}"] != launches2[f"dense_conv_{m}"]:
            raise AssertionError(f"second main path: {launches2[f'conv_pack_{m}']} packs for "
                                 f"{launches2[f'dense_conv_{m}']} {m} dense convs")
    for (mode, be, x, qt), y in zip(requests2, out2):
        what = f"main-path qmm {mode} backend={be} {tuple(x.shape)}"
        if y.shape != (x.shape[0], qt.out_features) or not torch.isfinite(y).all():
            raise AssertionError(f"{what}: shape {tuple(y.shape)} or non-finite values")
        if mode == "f32":
            ref = torch.matmul(x.double(), qt.payload["w"].double())
            if not torch.allclose(y.double(), ref, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"{what}: differs from the float64 product")
        elif mode in ("int8", "int4"):
            check.equal(f"affine_gemm_u{mode[-1]}", y, ops.qmm(x, qt, backend="torch"), what)
        else:
            check.equal(f"dense_gemm_{mode}", y, ops.qmm(x, qt, backend="torch"), what)
            if not torch.equal(y, ops.qmm(x, qt)):
                raise AssertionError(f"{what}: dense != popcount kernel")
    for i, (got, want) in enumerate(zip(dense_logits, logits)):
        if not torch.equal(got, want):
            raise AssertionError(f"dense CNN logits of batch {i} differ from the popcount CNN")
    layer_by_layer(PAPER_CNN, dense_model, model, images[-1], check,
                   lambda mode: f"dense_conv_{mode}", "dense vs popcount CNN")
    log(f"[main2] PaperCNN(PAPER_CNN, backend=\"dense\") batch {BATCH}: "
        f"{(BATCHES - 1) * BATCH / dense_s:.1f} images/s "
        f"({dense_s * 1e3 / (BATCHES - 1):.3f} ms/batch, host clock) vs popcount "
        f"{(BATCHES - 1) * BATCH / cnn_s:.1f} images/s ({cnn_s * 1e3 / (BATCHES - 1):.3f} "
        f"ms/batch); logits and every layer's map equal to the popcount CNN's; qmm "
        f"dense == popcount, u8/u4 == plain")
    # -- 7. the LM path (7a-7c: after both CNN timings, before any profiler
    # session) ------------------------------------------------------------
    lm_report, lm_launches, lm_state = lm_phase(torch, dev)
    log(card)
    # -- 8. MoE, SSM, the paged cache and the indexed backend (before any
    # profiler session) ----------------------------------------------------
    lm8_report, lm8_launches = phase8(torch, dev, lm_state)
    for k_, v_ in lm8_launches.items():
        lm_launches[k_] = lm_launches.get(k_, 0) + v_
    log(card)

    # a qmm request launches its quantization's kernels and the GeMM, no copy
    # of the per-tensor activation scale (both backends).  torch.profiler
    # counts the kernels; it runs only after the timed batches, since a
    # profiler session leaves launches slower for the rest of the process.
    counts = {}
    for mode, x, qt in requests[::len(GEMM_GRID["height"])]:
        n_quant = kernel_launches(lambda: ops.quantize_activations(x, qt.mode))
        for be in ("cuda", "dense"):
            n_qmm = kernel_launches(lambda: ops.qmm(x, qt, backend=be))
            counts[f"{mode}/{be}"] = [n_quant, n_qmm]
            if n_qmm != n_quant + 1:
                raise AssertionError(f"qmm {mode} backend={be}: {n_qmm} kernels, its "
                                     f"quantization {n_quant} + the GeMM expected")
    log(f"[main2] kernels per qmm request [quantize_activations, qmm]: "
        f"{json.dumps(counts)}: the GeMM and nothing else beside the quantization")

    # -- 5c. Table III on the card -----------------------------------------
    t0 = time.perf_counter()
    t3_events = {a: [] for a in TABLE3}
    t3_device = {a: [] for a in TABLE3}
    for h, w, d in grid:
        fa = torch.randn((h, d), generator=gen, device=dev)
        fb = torch.randn((d, w), generator=gen, device=dev)
        a8 = torch.randint(0, 256, (h, d), generator=gen, device=dev, dtype=torch.uint8)
        b8 = torch.randint(0, 256, (d, w), generator=gen, device=dev, dtype=torch.uint8)
        pa = int4_matmul.pack_nibbles_rows(a8 & 0xF)
        pb = int4_matmul.pack_nibbles_cols(b8 & 0xF)
        calls = {"f32": lambda: torch.matmul(fa, fb),
                 "u8": lambda: int8_matmul.int8_matmul_cuda(a8, b8),
                 "u4": lambda: int4_matmul.int4_matmul_cuda(pa, pb)}
        for mode in MODES:
            a_pl, b_pl, _, _, _ = gemm_operands(mode, h, w, d, dev, gen)
            calls[mode] = (lambda f=gemm_fns(mode)["_cuda"], args=a_pl + b_pl + [d]: f(*args))
        for algo in TABLE3:
            t3_events[algo].append(cuda_ms(calls[algo], reps=20))
            # a shape whose device time the profiler never recorded is left
            # out (nan)
            t3_device[algo].append(kernel_device_ms(calls[algo], "", reps=5) or float("nan"))

    def ratios(times):
        return {f"{r}/{c}": float(np.nanmean([tr / tc for tr, tc in zip(times[r], times[c])]))
                for r in TABLE3 for c in TABLE3}

    r_events, r_device = ratios(t3_events), ratios(t3_device)
    log("[table3] " + json.dumps({
        "shapes": len(grid), "algos": list(TABLE3),
        "what": "integer cores on pre-packed operands: f32 torch.matmul (TF32 off), "
                "u8/u4 raw accumulator kernels, tnn/tbn/bnn popcount int32 kernels",
        "mean_ms_events": {a: float(np.mean(v)) for a, v in t3_events.items()},
        "mean_ms_device": {a: float(np.nanmean(v)) for a, v in t3_device.items()},
        "device_shapes_measured": {a: int(np.isfinite(v).sum()) for a, v in t3_device.items()},
        "grid_hwd": grid, "ms_events": t3_events, "ms_device": t3_device,
        "ratio_events": r_events, "ratio_device": r_device,
        "speedup_device_like_paper": {k: r_device[f"{k.split('/')[1]}/{k.split('/')[0]}"]
                                      for k in PAPER_A73},
        "speedup_events_like_paper": {k: r_events[f"{k.split('/')[1]}/{k.split('/')[0]}"]
                                      for k in PAPER_A73},
        "paper_a73_speedup": PAPER_A73, "seconds": time.perf_counter() - t0}))
    log("[table3] device E[T_row / T_col]:   " + " ".join(f"{a:>7s}" for a in TABLE3))
    for r in TABLE3:
        log(f"[table3] {r:>26s} " + " ".join(f"{r_device[f'{r}/{c}']:7.3f}" for c in TABLE3))

    # -- 6. times ----------------------------------------------------------
    def bound(popc, nbytes):
        return popc_bound(popc, nbytes, max_sm_mhz)

    # where one CNN batch's device time goes, by kernel: the repository's
    # kernels by name (the packing pass, the conv kernels), the rest is
    # PyTorch's own (statistics, ReLU, max-pool, the float first layer)
    def by_kernel(rows):
        ours = {k: sum(ms for name, ms, _ in rows if k in name)
                for k in ("conv_pack_kernel", "lowbit_conv_kernel", "dense_conv_kernel")}
        ours["pytorch_kernels"] = sum(ms for name, ms, _ in rows
                                      if "lowbit::" not in name and "tc::" not in name)
        return ours

    for tag, net, secs in (("[profile]", model, cnn_s), ("[profile dense]", dense_model, dense_s)):
        rows, prof_ms = profiled(lambda: net(images[-1]))
        dev_ms = sum(r[1] for r in rows)
        batch_ms = secs * 1e3 / (BATCHES - 1)
        log(f"{tag} " + json.dumps({
            "cnn_batch_ms_host": batch_ms, "cnn_batch_ms_host_profiled": prof_ms,
            "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / batch_ms,
            "device_ms_by_kernel": by_kernel(rows),
            "top": [[name[:80], ms, calls] for name, ms, calls in rows[:14]]}))

    t0 = time.perf_counter()
    cnn256 = cnn_gemm_shapes(PAPER_CNN, BATCH)
    gemm = {r["name"]: r for r in gemm_rows(dev, gen, requests, cnn256, max_sm_mhz, check)}
    log(f"[times] GeMM rows at the GEMM_GRID diagonal and the CNN im2col shapes at batch "
        f"{BATCH} ({time.perf_counter() - t0:.1f} s); im2col outputs == plain, dense == "
        f"popcount")

    def gemm_kernel(name, source, replaces, n_launches):
        row = dict(gemm[name])
        row.update({"route": "cuda", "source": source, "replaces": replaces,
                    "launches": n_launches, "max_abs_err": check.max_err[name]})
        return row

    kernels = []
    for mode in MODES:
        for fused in (True, False):
            name = f"lowbit_gemm_{mode}_{'fused' if fused else 'i32'}"
            kernels.append(gemm_kernel(name, GEMM_SOURCE, GEMM_REPLACES[(mode, fused)],
                                       launches.get(name, 0)))

    def conv_layers(mode):
        """(x, qt, stride, stats, planes) of each PAPER_CNN layer of ``mode``
        at the main path's batch."""
        out = []
        for i, (spec, layer) in enumerate(zip(PAPER_CNN.convs, model.layers)):
            if spec.mode != mode:
                continue
            x = layer_inputs[i].contiguous()
            qt = layer.packed
            kh, kw_ = qt.geometry[:2]
            out.append((x, qt, spec.stride,
                        conv_fused.conv_act_stats(x, qt.mode, kh, kw_, spec.stride, "SAME"),
                        conv_fused.conv_weight_planes(qt)))
        return out

    def conv_row(name, source, replaces, wrapper, plain, patterns, tc, n_launches):
        """One conv row: the wrapper (pack + conv) over the mode's layers."""
        mode = name.rsplit("_", 1)[1]
        ms = plain_ms = lib_ms = lib16_ms = bound_ms = device_ms = 0.0
        by, shp = set(), []
        for x, qt, stride, stats, planes in conv_layers(mode):
            kh, kw_, cin, cout = qt.geometry
            args = (qt.mode, x, planes, qt.geometry, stride, "SAME", stats,
                    qt.scale.reshape(1, cout), None)
            ms += cuda_ms(lambda: wrapper(*args), reps=20)
            device_ms += kernel_device_ms(lambda: wrapper(*args), patterns) or 0.0
            plain_ms += cuda_ms(lambda: plain(*args), reps=3, warmup=1)
            xq = conv_fused.quantize_patch_values(x, qt.mode, stats.get("thr"))
            wq = torch.sign(qt.to_dense().reshape(kh, kw_, cin, cout).permute(3, 2, 0, 1))
            x32, w32 = xq.permute(0, 3, 1, 2).contiguous(), wq.contiguous()
            lib_ms += cuda_ms(lambda: F.conv2d(x32, w32, stride=stride, padding=kh // 2),
                              reps=20)
            # bf16 in channels_last: the NHWC tensor's NCHW view already is
            x16 = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
            w16 = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            lib16_ms += cuda_ms(lambda: F.conv2d(x16, w16, stride=stride, padding=kh // 2),
                                reps=20)
            b, h, w, _ = x.shape
            oh, ow, _, _ = conv_fused.conv_out_hw(h, w, kh, kw_, stride, "SAME")
            m, words = b * oh * ow, planes[0].shape[1]
            nbytes = x.numel() * 4 + 4 * cout * words * len(planes) + 4 * m * cout
            if tc:
                b_ms, b_by = tc_bound(2 * m * cout * kh * kw_ * cin, nbytes + 4 * cout)
            else:
                b_ms, b_by = bound(m * cout * words * NPOPC[mode], nbytes)
            bound_ms += b_ms
            by.add(b_by)
            shp.append([b, h, w, cin, cout, kh])
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": check.max_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if "operations" in by else "bytes",
            "library_ms": lib_ms, "library_bf16_ms": lib16_ms,
            "device_ms": device_ms or None, "shapes_bhwcok": shp}

    for mode in MODES:
        ms = plain_ms = bound_ms = device_ms = 0.0
        shp = []
        for x, qt, stride, stats, _ in conv_layers(mode):
            kh, kw_ = qt.geometry[:2]
            args = (qt.mode, x, kh, kw_, stride, "SAME", stats)
            ms += cuda_ms(lambda: conv_fused.conv_pack_cuda(*args), reps=20)
            device_ms += kernel_device_ms(lambda: conv_fused.conv_pack_cuda(*args),
                                          "conv_pack_kernel") or 0.0
            plain_ms += cuda_ms(lambda: conv_fused.conv_pack_torch(*args), reps=5, warmup=1)
            out_words = sum(p.numel() for p in conv_fused.conv_pack_cuda(*args))
            b_ms, _ = bound(0, x.numel() * 4 + 4 * out_words)
            bound_ms += b_ms
            shp.append(list(x.shape))
        name = f"conv_pack_{mode}"
        kernels.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE, "replaces": PACK_REPLACES,
            "launches": launches.get(name, 0), "launches_dense_path": launches2.get(name, 0),
            "max_abs_err": check.max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "device_ms": device_ms or None, "shapes_bhwc": shp})

    for mode in MODES:
        kernels.append(conv_row(f"lowbit_conv_{mode}", CONV_SOURCE, CONV_REPLACES,
                                conv_fused.conv_fused_cuda, conv_fused.conv_fused_torch,
                                ("conv_pack_kernel", "lowbit_conv_kernel"), False,
                                launches.get(f"lowbit_conv_{mode}", 0)))

    for mode in MODES:
        kernels.append(gemm_kernel(f"dense_gemm_{mode}", DENSE_SOURCE, DENSE_GEMM_REPLACES,
                                   launches2.get(f"dense_gemm_{mode}", 0)))

    for mode in MODES:
        kernels.append(conv_row(f"dense_conv_{mode}", DENSE_SOURCE, DENSE_CONV_REPLACES,
                                dense_fused.dense_conv_fused_cuda,
                                dense_fused.dense_conv_fused_torch,
                                ("conv_pack_kernel", "dense_conv_kernel"), True,
                                launches2.get(f"dense_conv_{mode}", 0)))

    for tag in ("u8", "u4"):
        kernels.append(gemm_kernel(f"affine_gemm_{tag}", AFFINE_SOURCE, AFFINE_REPLACES[tag],
                                   launches2.get(f"affine_gemm_{tag}", 0)))

    log(f"[times] per kernel: ms = sum over the main path's calls of that kernel "
        f"(GeMM, dense GeMM, u8/u4: one request per GEMM_GRID diagonal shape; pack, conv, "
        f"dense conv: one batch of {BATCH}; a conv row's wrapper runs pack + conv), CUDA "
        f"events around back-to-back wrapper calls; device_ms = the kernels' own device "
        f"time from torch.profiler (conv rows: pack + conv kernels); popcount "
        f"bound at max SM clock {max_sm_mhz:.0f} MHz, tensor-core bound at 1,979 TOP/s "
        f"int8; total run {time.perf_counter() - t_start:.1f} s")
    # -- 7d. the LM path under torch.profiler --------------------------------
    a = lm_report["7a"]
    lm_report["7d"] = lm_profile(torch, *lm_state[:3], a["tnn_prefill_ms"],
                                 a["tnn_decode_ms_per_token"])
    log("[lm 7d] " + json.dumps(lm_report["7d"]))
    for k in kernels:
        if k["name"] in lm_launches:
            k["launches_lm_path"] = lm_launches[k["name"]]
    log(f"[lm] {LM_ARCH} (22 x 2048, GQA 32/4, d_ff 5632, vocab 32000, bf16), batch "
        f"{LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_STEPS} greedy steps: tnn packed "
        f"prefill {a['tnn_prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{a['tnn_decode_ms_per_token']:.3f} ms/token; bf16 prefill "
        f"{a['bf16_prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{a['bf16_decode_ms_per_token']:.3f} ms/token; busy share prefill "
        f"{lm_report['7d']['prefill']['device_busy_share']:.3f}, decode "
        f"{lm_report['7d']['decode_step']['device_busy_share']:.3f}; projection bytes "
        f"bf16 / tnn packed {a['projection_bytes']['ratio_bf16_over_packed']:.2f}; kernels "
        f"== plain, packed == QAT; phase {lm_report['phase_s']:.1f} s")
    r8a, r8b, r8c = lm8_report["8a"], lm8_report["8b"], lm8_report["8c"]
    log(f"[lm 8] {MOE_ARCH} (24 x 2048, 60 experts top-4 of d_ff 1408, shared 5632) "
        f"batch {LM_BATCH} x {LM_PROMPT}, {MOE_STEPS} steps: prefill "
        f"{r8a['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{r8a['decode_ms_per_token']:.3f} ms/token (bound {r8a['decode_bound_ms']:.3f}), aux "
        f"{r8a['aux_loss']:.6f}; {SSM_ARCH} (48 x 2048) batch {LM_BATCH} x {SSM_PROMPT}, "
        f"{SSM_STEPS} steps: prefill {r8b['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{r8b['decode_ms_per_token']:.3f} ms/token (bound {r8b['decode_bound_ms']:.3f}); "
        f"{LM_ARCH} tnn2 paged: prefill {r8c['prefill_tokens_per_s']:.1f} tokens/s, decode "
        f"{r8c['decode_ms_per_token']:.3f} ms/token (bound {r8c['decode_bound_ms']:.3f}), "
        f"cache bytes bf16 / tnn2 {r8c['cache_bytes']['ratio']:.2f}; indexed == popcount; "
        f"kernels == plain, packed == QAT; phase {lm8_report['phase_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
