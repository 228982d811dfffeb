#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the kernels from this checkout, holds every kernel
against its plain PyTorch version, drives the main path, times it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times [--src DIR]
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --train-mesh

The second form runs phases 1, 2 and the GeMM rows of phase 6 only
(popcount, dense, u8 and u4), for the ``repro_torch`` package under
``DIR`` (default this checkout's ``src``): the way to time another
checkout's GeMM kernels, e.g. the parent commit's, on the same card.
The third runs phases 1, 2 and 11 only, the fourth phases 1, 2 and 12.
Phases 11 and 12 start this script again as each of their ranks
(``--mesh-rank DIR``, ``--train-mesh-rank DIR``, not for direct use).

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
9. serving (right after 8d, before any profiler session), on phase 7a's
   packed TinyLlama-1.1B at full width and depth, ``SERVE_REQUESTS``
   greedy requests (prompt lengths drawn from ``SERVE_PROMPT`` with
   numpy seed 0, token ids uniform over the vocabulary,
   ``SERVE_NEW_TOKENS`` new tokens each) submitted at once, so slots
   refill while others decode:
   9a. the bucket ``Engine`` (``SERVE_SLOTS`` slots, ``max_len``
       ``SERVE_MAX_LEN``, buckets from ``SERVE_BUCKET``): untuned (an
       empty plan cache), then ``autotune="offline"`` (the sweep over
       every packed (k, n) at the decode m and every bucket, plans in
       ``build/chip_smoke/tune_plans.json``), then on the plain versions;
       every Result "ok" with 1 + ``SERVE_NEW_TOKENS`` tokens; tokens and
       logit traces ``torch.equal`` across the three; exactly 7 x 22
       fused TNN launches per forward, forwards = prefill calls + decode
       ticks from the engine's metrics; a plan for every (k, n) at every
       m bucket; each plan's tile beside ``gemm_tile``'s and the
       candidates' times; generated tokens/s, TTFT and inter-token
       latency (p50, p99) from the engine's metrics;
   9b. the chunked engine on the paged ``tnn2`` cache (pages of
       ``PAGED_PAGE``, chunks of ``PAGED_CHUNK``), the same requests:
       all "ok", ``torch.equal`` to its plain run, no page used after the
       drain, the allocator balanced after ``close()``; cache bytes
       against the bf16 slab of the same slots;
   9c. an armed ``kernel.compile`` fault on a ``qmm`` raises out of
       ``Engine.step()``; ``run()`` quarantines: the in-flight requests
       finish as "error" with their pages released and no launch on
       another backend; disarmed, a fresh engine serves "ok";
   9d. ``repro_torch.launch.serve.main`` (``--arch tinyllama-1.1b --quant
       tnn --requests 4 --slots 2 --new-tokens 8``) in-process on the
       card: four "ok" results, fused TNN launches only;
10. training (right after 9d, before any profiler session), launch
    counters zeroed just before each step and read just after:
    10a. a ``Trainer`` of QAT under ``tnn`` on TinyLlama-1.1B at its
        published width and depth (float32 masters, bf16 compute copies,
        ``cfg.remat``: each period checkpointed), random weights from a
        generator on the card, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens a
        step from ``SyntheticLM`` seed 0, AdamW (lr 3e-4, warm-up 1,
        float32 moments): one warm-up step, ``TRAIN_TIMED`` timed ones
        (host clock around each synchronized step); finite losses,
        exactly 2 x 7 x 22 = 308 fused TNN GeMM launches per step and
        nothing else; ms per step and tokens/s beside the float32 bound
        (``train_flops`` at 67 TFLOP/s), peak memory, moment bytes;
    10b. one step from the same state and batch with ``quant_backend=
        "cuda"`` and ``"torch"`` (the plain versions), under
        ``torch.use_deterministic_algorithms``: the loss, every gradient
        leaf and every updated parameter ``torch.equal``; twice: at full
        depth on 1 x ``TRAIN_SEQ`` tokens (308 launches on the kernels),
        and at 10a's rows, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (m = 4,096 per
        projection), at ``LM_CUT_LAYERS`` layers (2 x 7 x 2 = 28
        launches); none on the plain runs;
    10c. ``moments_dtype="int8"`` with ``ef_compression``, 2 steps: finite
        losses, 308 launches a step, moment bytes beside 10a's; then
        ``microbatch=2`` against 1 under the ``bf16`` policy (the
        reference's own check; under ``tnn`` each microbatch quantizes
        with its own per-tensor statistics): first-step losses within
        ``rtol=1e-4``;
    10d. resume at full width and ``LM_CUT_LAYERS`` layers, deterministic:
        4 steps with saves at 2 and 4; a fresh ``Trainer`` restores step
        2 and runs steps 3-4: its losses and its final checkpoint equal
        to the uninterrupted run's; checkpoint bytes, save and restore
        seconds, in a directory under ``build/`` removed afterwards;
    10e. ``repro_torch.launch.train.main`` (``--arch tinyllama-1.1b
        --smoke --quant tnn --steps 30 --lr 3e-3``) in-process on the card:
        exactly 14 fused TNN launches a step, the mean of the last five
        losses below the first five's;
    10f. (after 7d) torch.profiler over one step of 10a's configuration
        after a warm-up step: device kernel time (popcount GeMMs, float
        GeMMs, the rest), kernels launched, busy share against 10a's
        unprofiled ms per step;
11. the serving mesh (after 10e, before any profiler session):
    ``MESH_WORLD`` ranks of this script (``--mesh-rank``) share the card
    over gloo (one card each over NCCL where the machine has
    ``MESH_WORLD``; ``launch.mesh.run_ranks``; the parent built the kernels,
    the ranks only load them; a rank past ``MESH_TIMEOUT_S`` is killed);
    rank 0 prints the backend, the rank count and each mesh; every rank
    must exit 0:
    11a. n-, k- and n+k-sharded ``qmm`` on a (2, 2) and a (1, 4)
        ("data", "model") mesh, TNN/TBN/BNN, backends ``cuda`` and
        ``dense``, at the GEMM_GRID diagonal (with a bias) and
        TinyLlama-1.1B's projection shapes at m = 512
        (``MESH_LM_SHAPES``): each output ``torch.equal`` to the
        single-device ``qmm`` on the card, itself equal to the plain
        versions; the launches and the all-reduces / gathers and their
        bytes;
    11b. cout-sharded ``qconv`` at every ``PAPER_CNN`` low-bit layer
        geometry (batch 8, with a bias), each mode, both backends, both
        meshes: ``torch.equal`` to the single-device ``qconv``;
    11c. TinyLlama-1.1B at its published width and depth under ``tnn``
        (phase 7a's weights) served by the mesh ``Engine`` on (1, 4):
        ``MESH_REQUESTS`` greedy requests of ``MESH_PROMPT`` tokens,
        ``MESH_NEW`` new tokens each, after one warm-up request; the
        tokens equal the single-device engine's on the same card,
        weights and config (run by the parent first); exactly 5 x 22
        fused and 2 x 22 int32 TNN GeMMs and 2 x 22 all-reduces per rank
        per forward (wq/wk/wv/gate/up n-sharded over "model", wo/down
        k-sharded), nothing else; each rank's packed-plane bytes a
        quarter of the single-device total; prefill and decode rates of
        the 4 ranks time-sharing one card (not a scaling figure);
    11d. the same model on (2, 2), one tick with every request in flight:
        exactly 2 x 22 fused and 5 x 22 int32 TNN GeMMs and 5 x 22
        all-reduces per forward (wq/wk/wv n over "model" and k over
        "data", wo/down k over "model", gate/up n over "model"); a
        fake-clock watchdog hears from every rank but rank 3, which it
        flags; ``rebuild_after_loss([3])`` gives (1, 2) on ranks 0 and 1
        (ranks 2 and 3 leave), the migrated requests finish there with
        the single-device tokens;
12. the training mesh (after 11, before any profiler session): first
    12a's configuration on one device (the reference), then
    ``TRAIN_MESH_WORLD`` ranks of this script (``--train-mesh-rank``) on a
    ``TRAIN_MESH_SHAPE`` ("data", "model") mesh under ``TRAIN_RULES``,
    sharing the card over gloo (one card each over NCCL where the machine
    has them); every rank must exit 0:
    12a. a ``Trainer`` of QAT under ``tnn`` on TinyLlama-1.1B at its
        published width and depth (remat, AdamW with int8 moments at lr
        ``TRAIN_MESH_LR``, EF compression, bf16 compute copies gathered
        over the mesh and bf16 cotangents reduce-scattered),
        ``ShardLayout(tp=2)``, ``TRAIN_MESH_STEPS`` steps of
        ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, each rank the rows of its
        "data" coordinate and the shards of every leaf by ``param_spec``;
        launch and collective counters zeroed just before each step and
        read just after: exactly 2 x 7 x 22 fused TNN GeMM launches per
        rank per step (the remat recompute doubles the forward's) and
        nothing else; the first forward's planes equal to one device's (a
        checksum of every projection's, ``torch.equal`` for the first
        layer's seven); the loss, ``grad_norm`` and each parameter leaf's
        sum of squares after each step within ``TRAIN_MESH_BOUNDS`` of one
        device's; ms per step and tokens/s of the ranks time-sharing the
        card (not a scaling figure) beside one device's, peak memory per
        rank, master / moment / EF bytes per rank against one device's,
        collectives per step with their bytes and host seconds; then the
        same at ``LM_CUT_LAYERS`` layers, every master elementwise against
        one device's;
    12b. at ``LM_CUT_LAYERS`` layers: 12a's state saved on the mesh (whole
        leaves, the reference's format), restored onto (4, 1) equal to the
        saved state re-sharded in memory, and one more step from each
        (under ``torch.use_deterministic_algorithms``) ``torch.equal``;
        save and restore seconds;
    12c. ``python -m repro_torch.launch.train --smoke --quant tnn`` on
        ``TRAIN_MESH_WORLD`` ranks (the (1, 4) host mesh): the loss falls;
13. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
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
# Phase 9, serving: SERVE_REQUESTS greedy requests submitted at once to
# an Engine of SERVE_SLOTS slots, prompt lengths drawn (numpy seed 0)
# from SERVE_PROMPT, SERVE_NEW_TOKENS new tokens each.  SERVE_MAX_LEN
# leaves the largest bucket (512) room for them: 512 + 16.
SERVE_REQUESTS, SERVE_SLOTS, SERVE_PROMPT, SERVE_NEW_TOKENS = 8, 4, (16, 400), 16
SERVE_BUCKET, SERVE_MAX_LEN = 128, 528
# Phase 10, training: QAT (tnn) on TinyLlama-1.1B at its published width
# and depth, TRAIN_BATCH x TRAIN_SEQ tokens a step from SyntheticLM seed 0,
# one warm-up step and TRAIN_TIMED timed ones; the resume check (10d) at
# LM_CUT_LAYERS layers; launch.train at smoke size for TRAIN_LAUNCH_STEPS.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED, TRAIN_LAUNCH_STEPS = 8, 512, 4, 30
FP32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside the tensor cores
# Phase 11, the serving mesh: MESH_WORLD ranks share the card over gloo
# (launch.mesh.run_ranks; a rank that overruns MESH_TIMEOUT_S is killed).
# 11a runs sharded qmm at the GEMM_GRID diagonal and MESH_LM_SHAPES
# (TinyLlama-1.1B's projections at m = 512, (m, n, k)) on every mesh of
# MESH_SHAPES; 11c and 11d serve MESH_REQUESTS greedy requests of
# MESH_PROMPT tokens, MESH_NEW new tokens each, on TinyLlama-1.1B at full
# width and depth (phase 7a's weights: generator seed 7 on the card).
MESH_WORLD, MESH_TIMEOUT_S, MESH_SHAPES = 4, 900, ((2, 2), (1, 4))
MESH_LM_SHAPES = [(512, 2048, 2048), (512, 256, 2048), (512, 5632, 2048), (512, 2048, 5632)]
MESH_REQUESTS, MESH_PROMPT, MESH_NEW = 4, 128, 16
MESH_CASES = {"n": ("model", None), "k": (None, "model"), "nk": ("model", "data")}
# Phase 12, the training mesh: TRAIN_MESH_WORLD ranks share the card over
# gloo (one card each over NCCL where the machine has them) as a
# TRAIN_MESH_SHAPE ("data", "model") mesh under TRAIN_RULES; 12a trains
# TRAIN_MESH_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens at lr
# TRAIN_MESH_LR (warm-up 1) and is held to the same steps on one device:
# TRAIN_MESH_BOUNDS[run][i] bounds the relative differences of step i's
# loss and grad_norm and, after the first step, of each parameter leaf's
# sum of squares.  The tnn runs' bounds are wide because the card's float
# products round differently at the rank's row count than at the whole
# batch's (cuBLAS picks its kernel by shape), and a ternary threshold turns
# a last-bit difference of an activation into a different ternary value;
# at 22 layers the differences compound (one device moves its own first
# loss by ~9e-4 when only the order of its rows changes).  "12a_f32" runs
# the same mesh at LM_CUT_LAYERS layers with float32 projections, no
# threshold, and holds it tight: its remaining differences are the float
# rounding and the bf16 wire.  At LM_CUT_LAYERS layers every tnn master
# after the first step is within 2 lr of one device's (a flipped gradient
# sign moves it by that much), and at most TRAIN_MESH_MOVED_MAX of them by
# more than 1e-3 lr.  The first step's grad_norm bounds, 12a's second
# step's and TRAIN_MESH_MOVED_MAX lie between the readings of a sound mesh
# and of one whose remat recompute quantizes with each rank's own
# statistics (PERF.md gives both for every bound).  The second update is not bounded
# elementwise: with int8 moments and EF (the reference's arithmetic, which
# the JAX package shows too) an element whose EF gradient rounds to 0 while
# its int8 v rounded to 0 and its m did not takes a step of m / eps.
TRAIN_MESH_WORLD, TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS = 4, (2, 2), 2
TRAIN_MESH_LR, TRAIN_MESH_TIMEOUT_S, TRAIN_MESH_MOVED_MAX = 3e-4, 900, 0.05
TRAIN_MESH_RUNS = (("12a", None, "tnn"), ("12a_cut", LM_CUT_LAYERS, "tnn"),
                   ("12a_f32", LM_CUT_LAYERS, "f32"))
TRAIN_MESH_BOUNDS = {
    "12a": ({"loss": 1e-2, "grad_norm": 7e-2, "sumsq": 1e-3},
            {"loss": 2e-3, "grad_norm": 7.5e-2, "sumsq": None}),
    "12a_cut": ({"loss": 1e-3, "grad_norm": 1e-3, "sumsq": 1e-3},
                {"loss": 2e-2, "grad_norm": 1e-1, "sumsq": None}),
    "12a_f32": ({"loss": 1e-5, "grad_norm": 1e-3, "sumsq": 1e-4},
                {"loss": 1e-4, "grad_norm": 1e-2, "sumsq": None}),
}


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


def serve_run(torch, engine, prompts, max_new):
    """Submit every prompt at once and drive ``engine.run()``; returns
    (results, host s, the TTFT and inter-token latencies the engine's
    metrics observed, {"prefill": calls of ``prefill`` or
    ``chunk_step``, "decode": calls of ``serve_step``})."""
    from repro_torch.serving import Request

    ttft, itl, calls = [], [], {"prefill": 0, "decode": 0}
    m = engine.obs
    real_ttft, real_itl = m.ttft.observe, m.itl.observe

    def counted(fn, what):
        def call(*a, **k):
            calls[what] += 1
            return fn(*a, **k)
        return call

    m.ttft.observe = lambda v, **kw: (ttft.append(v), real_ttft(v, **kw))
    m.itl.observe = lambda v, **kw: (itl.append(v), real_itl(v, **kw))
    engine.serve_step = counted(engine.serve_step, "decode")
    first = "chunk_step" if hasattr(engine, "chunk_step") else "prefill"
    setattr(engine, first, counted(getattr(engine, first), "prefill"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p, max_new_tokens=max_new))
    results = engine.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, ttft, itl, calls


def serve_equal(got, want, what):
    """Two engine runs: the same statuses and tokens, and (when both kept
    them) every logit trace row equal."""
    import numpy as np

    (res_a, eng_a), (res_b, eng_b) = got, want
    for uid in res_b:
        a, b = res_a[uid], res_b[uid]
        if (a.status, a.tokens) != (b.status, b.tokens):
            raise AssertionError(f"{what}: uid {uid} differs: {a.status} {a.tokens} vs "
                                 f"{b.status} {b.tokens}")
        if eng_a.logit_trace is not None and eng_b.logit_trace is not None:
            rows_a, rows_b = eng_a.logit_trace[uid], eng_b.logit_trace[uid]
            if len(rows_a) != len(rows_b) or not all(
                    np.array_equal(x, y) for x, y in zip(rows_a, rows_b)):
                raise AssertionError(f"{what}: uid {uid}: logit traces differ")


def percentiles(vals):
    import numpy as np

    return {"p50": float(np.percentile(vals, 50)), "p99": float(np.percentile(vals, 99)),
            "n": len(vals)} if vals else {"n": 0}


def phase9(torch, dev, lm_state, card):
    """Phase 9a-9d (see the module docstring): the serving engine, its
    tuner, faults and the launcher on phase 7a's TinyLlama-1.1B.  Nothing
    here runs under torch.profiler.  Returns (the report, {kernel:
    launches})."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels._matmul_common import gemm_tile, sm_count
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import ShardLayout
    from repro_torch.resilience import faults
    from repro_torch.serving import Engine, Request, ServeConfig
    from repro_torch.tune import cache as plan_cache
    from repro_torch.tune import tuner

    t_phase = time.perf_counter()
    packed, cfg = lm_state[0], lm_state[1]
    lay = ShardLayout()
    report, launches9 = {}, {}
    key = LM_POLICY_KERNELS["tnn"]
    per_forward = tnn_gemms_per_forward(cfg)
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lengths]
    tune_dir = ROOT / "build" / "chip_smoke"
    tune_dir.mkdir(parents=True, exist_ok=True)
    plans_path, off_path = tune_dir / "tune_plans.json", tune_dir / "tune_off.json"
    for p in (plans_path, off_path):
        p.unlink(missing_ok=True)

    def engine(c, autotune, **over):
        kw = dict(num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                  prefill_bucket=SERVE_BUCKET, pack_params=True, autotune=autotune,
                  trace_logits=True)
        kw.update(over)
        t0 = time.perf_counter()
        eng = Engine(packed, c, lay, ServeConfig(**kw))
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def metrics(eng, res, secs, ttft, itl, calls):
        toks = sum(len(r.tokens) for r in res.values())
        return {"requests": len(res), "generated_tokens": toks, "host_s": secs,
                "generated_tokens_per_s": toks / secs, "decode_ticks": calls["decode"],
                "prefill_calls": calls["prefill"],
                "scheduler_steps": eng.obs.steps.total(),
                "admissions": eng.obs.admissions.total(),
                "ttft_s": percentiles(ttft), "inter_token_s": percentiles(itl),
                "ttft_mean_s": eng.obs.ttft.sum() / max(1, eng.obs.ttft.count()),
                "inter_token_mean_s": eng.obs.itl.sum() / max(1, eng.obs.itl.count())}

    def all_ok(res, n_tokens, what):
        bad = {u: (r.status, len(r.tokens)) for u, r in res.items()
               if r.status != "ok" or len(r.tokens) != n_tokens}
        if len(res) != SERVE_REQUESTS or bad:
            raise AssertionError(f"{what}: {len(res)} results, not ok or not {n_tokens} "
                                 f"tokens: {bad}")

    def forwards_of(run, eng, what):
        """Prefill calls + decode ticks, each counted two ways: the step
        functions' calls and the engine's own metrics."""
        calls = run[4]
        if (calls["prefill"], calls["decode"]) != (eng.obs.admissions.total(),
                                                   eng.obs.steps.total()):
            raise AssertionError(f"{what}: {calls} step calls, but {eng.obs.admissions.total()}"
                                 f" admissions and {eng.obs.steps.total()} ticks")
        return calls["prefill"] + calls["decode"]

    # -- 9a. bucket engine: untuned and offline-tuned (in turns), plain --------
    n_tok = 1 + SERVE_NEW_TOKENS           # the prefill's token, then the decoded ones
    runs = {"untuned": [], "tuned": []}
    plan_cache.set_cache_path(str(off_path))
    off, _ = engine(cfg, "off")
    runs["untuned"].append((serve_run(torch, off, prompts, SERVE_NEW_TOKENS), off))
    plan_cache.set_cache_path(str(plans_path))
    tuned, sweep_s = engine(cfg, "offline")
    _build.reset_launches()
    run = serve_run(torch, tuned, prompts, SERVE_NEW_TOKENS)
    launches = _build.launches()
    runs["tuned"].append((run, tuned))
    forwards = forwards_of(run, tuned, "9a")
    want = {key: per_forward * forwards}
    if launches != want:
        raise AssertionError(f"9a: launches {launches}, expected {want} ({per_forward} x "
                             f"(prefill calls + decode ticks))")
    for k_, v_ in launches.items():
        launches9[k_] = launches9.get(k_, 0) + v_
    # the second pair in the other order: tuned, then untuned
    for name, path, autotune in (("tuned", plans_path, "off"), ("untuned", off_path, "off")):
        plan_cache.set_cache_path(str(path))
        eng, _ = engine(cfg, autotune)
        runs[name].append((serve_run(torch, eng, prompts, SERVE_NEW_TOKENS), eng))
        eng.close()
    plan_cache.set_cache_path(str(plans_path))
    off_run = runs["untuned"][0][0]
    for name, pair in runs.items():
        for i, (r, eng) in enumerate(pair):
            all_ok(r[0], n_tok, f"9a {name} run {i}")
            serve_equal((r[0], eng), (off_run[0], off), f"9a: {name} run {i} vs untuned")
    # the plain versions' word_chunk, tuned at the same shapes: the plain
    # engines below (9a, 9b) run the fastest chunking the sweep found
    t0 = time.perf_counter()
    shapes = [(m_, n_, k_) for _, k_, n_, _ in tuner.collect_problems(tuned.params)
              for m_ in sorted({SERVE_SLOTS, *tuned._buckets()})]
    plain_plans = tuner.tune_shapes(shapes, [QuantMode.TNN], ["torch"], reps=2, warmup=1,
                                    device=dev)[0]
    plain_sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain, _ = engine(cfg.with_(quant_backend="torch"), "off")
    plain_run = serve_run(torch, plain, prompts, SERVE_NEW_TOKENS)
    plain_s = time.perf_counter() - t0
    serve_equal((run[0], tuned), (plain_run[0], plain), "9a: kernels vs plain engine")
    # a plan for every (k, n) of the projections at every m of the sweep
    plans = plan_cache.PlanCache(str(plans_path)).load().plans()
    kind = plan_cache.device_kind(dev)
    kn = sorted({(k_, n_) for _, n_, k_ in proj_shapes(cfg, 1, 1)})
    buckets = sorted({plan_cache.bucket_m(m_) for m_ in tuned._buckets() + [SERVE_SLOTS]})
    table, sms = [], sm_count(dev.index or 0)
    for k_, n_ in kn:
        for mb in buckets:
            pkey = plan_cache.plan_key(QuantMode.TNN, "cuda", True, kind, mb, n_, k_)
            if pkey not in plans:
                raise AssertionError(f"9a: no plan {pkey} in {plans_path}")
            rep = tuned.tune_reports.get(pkey, {})
            table.append({"k": k_, "n": n_, "m_bucket": mb,
                          "tile": plans[pkey].tiles.cta_tile,
                          "gemm_tile_default": gemm_tile(mb, n_, sms),
                          "candidates_ms": {str(c["tiles"]["cta_tile"]): c["median_s"] * 1e3
                                            for c in rep.get("candidates", [])}})
    report["9a"] = {
        "config": {"arch": cfg.name, "num_layers": cfg.num_layers, "d_model": cfg.d_model,
                   "num_slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
                   "prefill_bucket": SERVE_BUCKET, "requests": SERVE_REQUESTS,
                   "prompt_lengths": [int(n) for n in lengths],
                   "max_new_tokens": SERVE_NEW_TOKENS, "sampler": "greedy",
                   "weights": "phase 7a's (packed under tnn)"},
        "sweep_s": sweep_s, "plans": table, "launches": launches, "forwards": forwards,
        "plain_sweep_s": plain_sweep_s,
        "plain_word_chunks": {p_.key: p_.tiles.word_chunk for p_ in plain_plans},
        "runs_in_order": "untuned, tuned, tuned, untuned",
        **{name: [metrics(eng, *r) for r, eng in pair] for name, pair in runs.items()},
        "plain_run_s": plain_s, "tuned_equals_untuned": True, "kernel_equals_plain": True}
    for e in (off, tuned, plain):
        e.close()
    del off, plain, runs
    log("[serve 9a] " + json.dumps(report["9a"]))
    log(card)

    # -- 9b. chunked engine on the paged tnn2 cache ----------------------------
    ccfg = cfg.with_(kv_cache_dtype="tnn2")
    chunked = dict(page_size=PAGED_PAGE, prefill_chunk=PAGED_CHUNK)
    ceng, _ = engine(ccfg, "offline", **chunked)
    _build.reset_launches()
    crun = serve_run(torch, ceng, prompts, SERVE_NEW_TOKENS)
    claunches = _build.launches()
    all_ok(crun[0], n_tok, "9b chunked")
    for k_, v_ in claunches.items():
        launches9[k_] = launches9.get(k_, 0) + v_
    cforwards = crun[4]["prefill"] + crun[4]["decode"]
    if claunches != {key: per_forward * cforwards}:
        raise AssertionError(f"9b: launches {claunches}, expected {per_forward} x "
                             f"{cforwards} (chunk calls + decode calls)")
    cplain, _ = engine(ccfg.with_(quant_backend="torch"), "off", **chunked)
    cplain_run = serve_run(torch, cplain, prompts, SERVE_NEW_TOKENS)
    serve_equal((crun[0], ceng), (cplain_run[0], cplain), "9b: kernels vs plain engine")
    used = [s["used"] for s in ceng.page_stats()]
    if any(used):
        raise AssertionError(f"9b: pages still used after the drain: {ceng.page_stats()}")
    kv = {s["labels"]["kind"]: s["value"]
          for s in ceng.metrics()["metrics"]["repro_engine_kv_cache_bytes"]["series"]}
    ceng.close()
    cplain.close()
    if any(s["used"] or s["free"] != s["total"] for s in ceng.page_stats()):
        raise AssertionError(f"9b: allocator unbalanced after close: {ceng.page_stats()}")
    report["9b"] = {
        "config": {"kv_cache_dtype": "tnn2", "page_size": PAGED_PAGE,
                   "prefill_chunk": PAGED_CHUNK, "same requests as 9a": True},
        "launches": claunches, "forwards": cforwards, "metrics": metrics(ceng, *crun),
        "pages_high_water": [s["high_water"] for s in ceng.page_stats()],
        "cache_bytes": {**kv, "ratio": kv.get("dense_equiv", 0) / max(1, kv.get("packed", 1))},
        "kernel_equals_plain": True, "pages_used_after_drain": used,
        "allocator_balanced_after_close": True}
    del ceng, cplain
    log("[serve 9b] " + json.dumps(report["9b"]))
    log(card)

    # -- 9c. an injected kernel failure raises; run() quarantines ---------------
    short = [p[:24] for p in prompts[:2]]

    def fault_engine():
        e, _ = engine(ccfg, "off", **chunked)
        for uid, p in enumerate(short):
            e.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        return e

    feng = fault_engine()
    faults.arm(faults.parse_plan("kernel.compile@5+6?op=qmm"))
    try:
        try:
            feng.step()
        except faults.InjectedFault as e:
            raised = str(e)
        else:
            raise AssertionError("9c: an armed kernel.compile did not raise out of step()")
        _build.reset_launches()
        fres = feng.run()
        flaunches = _build.launches()
        report_plan = faults.active().report()
    finally:
        faults.disarm()
    if [fres[u].status for u in sorted(fres)] != ["error", "error"]:
        raise AssertionError(f"9c: expected both in-flight requests as error, got "
                             f"{ {u: r.status for u, r in fres.items()} }")
    if any(s["used"] for s in feng.page_stats()):
        raise AssertionError(f"9c: pages not released: {feng.page_stats()}")
    errors = feng.obs.step_errors.total()
    feng.close()
    fresh = fault_engine()
    again = fresh.run()
    if [again[u].status for u in sorted(again)] != ["ok", "ok"]:
        raise AssertionError("9c: a fresh engine does not serve after disarming")
    fresh.close()
    report["9c"] = {"plan": "kernel.compile@5+6?op=qmm", "step_raised": raised,
                    "run_statuses": {u: r.status for u, r in fres.items()},
                    "launches_in_quarantined_run": flaunches, "plan_report": report_plan,
                    "step_errors": errors, "pages_released": True,
                    "fresh_engine_statuses": {u: r.status for u, r in again.items()}}
    log("[serve 9c] " + json.dumps(report["9c"]))

    # -- 9d. the launcher, in-process on the card -------------------------------
    t0 = time.perf_counter()
    _build.reset_launches()
    lres = launch_serve.main(["--arch", LM_ARCH, "--quant", "tnn", "--requests", "4",
                              "--slots", "2", "--new-tokens", "8"])
    llaunches = _build.launches()
    if len(lres) != 4 or any(r.status != "ok" or len(r.tokens) != 9 for r in lres.values()):
        raise AssertionError(f"9d: launch.serve results {lres}")
    if set(llaunches) != {key}:
        raise AssertionError(f"9d: launches {llaunches}")
    for k_, v_ in llaunches.items():
        launches9[k_] = launches9.get(k_, 0) + v_
    report["9d"] = {"argv": "--arch tinyllama-1.1b --quant tnn --requests 4 --slots 2 "
                            "--new-tokens 8", "s": time.perf_counter() - t0,
                    "launches": llaunches,
                    "statuses": sorted({r.status for r in lres.values()})}
    log("[serve 9d] " + json.dumps(report["9d"]))
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    return report, launches9


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True)`` for a comparison of two
    runs (the embedding's and ``torch.gather``'s backward scatter-add with
    atomics otherwise).  That mode refuses cuBLAS calls unless
    ``CUBLAS_WORKSPACE_CONFIG`` is set, so it is set for the duration.
    PyTorch reads the variable once, when cuBLAS first picks its workspace
    size, long before this point: here it only satisfies the check and
    does not change cuBLAS (set for the whole script, it made every small
    cuBLAS call several times slower on the host, and with it the library
    yardsticks of phase 6).  Equal results rest on cuBLAS being
    reproducible on one stream, which the comparison's ``torch.equal``
    verifies on every run."""
    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old


def train_flops(cfg, batch, seq) -> float:
    """Float32 operations of one QAT step of ``cfg`` at (batch, seq), from
    shapes: per projection the STE backward's two products (gx, gw: 4 m n
    k; the forward is the popcount GeMM), the head's bf16-operand product
    forward and backward (6 m d V), and per attention layer and sequence
    QK^T and PV (4 S^2 d) in the forward, the remat recompute and twice in
    the backward (16 S^2 d)."""
    m = batch * seq
    proj = sum(4 * mm * n * k for mm, n, k in proj_shapes(cfg, m, 0))
    head = 6 * m * cfg.d_model * cfg.vocab_size
    attn = sum(m_ in ("A", "AL") for m_, _ in cfg.layer_pattern) * cfg.num_periods
    hd = cfg.num_heads * cfg.head_dim_
    return proj + head + attn * batch * 16 * seq * seq * hd


def phase10(torch, dev):
    """Phase 10a-10e (see the module docstring); nothing here runs under
    torch.profiler.  Returns (the report, {sub-phase: {kernel: launches}}
    for 10a and 10c at full width and 10e at the smoke width)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointConfig, Checkpointer, save_tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataState, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.models import ShardLayout
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig, init_train_state
    from repro_torch.train import train_step as tts
    from repro_torch.tree import flatten_with_paths

    t_phase = time.perf_counter()
    lay = ShardLayout()
    report, launches10 = {}, {"10a": {}, "10c": {}, "10e": {}}
    key = LM_POLICY_KERNELS["tnn"]
    cfg = get_config(LM_ARCH, quant_policy="tnn")
    # remat runs each period's forward a second time in the backward
    per_step = (2 if cfg.remat else 1) * tnn_gemms_per_forward(cfg)
    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1))
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def add(phase, launches):
        for k, v in launches.items():
            launches10[phase][k] = launches10[phase].get(k, 0) + v

    def trainer(c, t, steps, **kw):
        return Trainer(c, lay, t, TrainerConfig(steps=steps, log_every=10**9, **kw), source,
                       device=dev, log_fn=log)

    def timed(tr):
        """Instrument ``tr``'s step: host clock around each synchronized
        step, launch counters zeroed just before it and read just after."""
        rows, inner = [], tr.step_fn

        def step(state, batch):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = inner(state, batch)
            float(out[1]["loss"])
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0, _build.launches()))
            return out

        tr.step_fn = step
        return rows

    def check_steps(rows, losses, what, want=None):
        want = {key: per_step} if want is None else want
        for i, (_, launches) in enumerate(rows):
            if launches != want:
                raise AssertionError(f"{what}: step {i} launched {launches}, expected {want}")
            add(what.split()[0], launches)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{what}: non-finite loss in {losses}")

    def moment_bytes(state):
        return sum(t.numel() * t.element_size() for _, t in flatten_with_paths(
            {"m": state["opt"]["m"], "v": state["opt"]["v"]}))

    def equal_trees(a, b, what):
        for (k, x), (_, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
            if not torch.equal(x, y):
                err = (x.double() - y.double()).abs().max().item()
                raise AssertionError(f"{what}: {k} differs (max abs err {err})")

    # -- 10a. QAT at full width: 1 warm-up + TRAIN_TIMED timed steps --------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = trainer(cfg, tcfg, 1 + TRAIN_TIMED)
    rows = timed(tr)
    state, ds = tr.restore_or_init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mom_f32 = moment_bytes(state)
    res = tr.run(state, ds)
    peak = torch.cuda.max_memory_allocated()
    check_steps(rows, res.losses, "10a")
    step_s = [r[0] for r in rows[1:]]
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    report["10a"] = {
        "arch": cfg.name, "num_layers": cfg.num_layers, "quant_policy": "tnn",
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": res.losses, "step_ms": [s * 1e3 for s in step_s],
        "warmup_step_ms": rows[0][0] * 1e3, "mean_step_ms": float(np.mean(step_s)) * 1e3,
        "tokens_per_s": tokens / float(np.mean(step_s)),
        "fused_tnn_launches_per_step": per_step, "peak_memory_bytes": peak,
        "moment_bytes_f32": mom_f32, "init_s": init_s, "step_flops_f32": flops,
        "step_bound_ms": flops / FP32_FLOPS_PER_S * 1e3}
    log("[train 10a] " + json.dumps(report["10a"]))
    del state, tr, res
    torch.cuda.empty_cache()

    # -- 10b. one step on the kernels and on the plain versions --------------
    def kernels_vs_plain(c, batch):
        """One step of ``c`` from the same state and batch on the kernels and
        on the plain versions, deterministic: loss, every gradient leaf and
        every updated parameter torch.equal.  -> the case's report."""
        want = {key: (2 if c.remat else 1) * tnn_gemms_per_forward(c)}
        runs = []
        with deterministic(torch):
            for cc in (c.with_(quant_backend="cuda"), c.with_(quant_backend="torch")):
                st = init_train_state(torch.Generator(device=dev).manual_seed(10), cc, lay,
                                      tcfg, device=dev)
                torch.cuda.synchronize()
                _build.reset_launches()
                t1 = time.perf_counter()
                (loss, _), grads = tts.value_and_grad(tts.make_loss_fn(cc, lay, tcfg),
                                                      st["params"], batch)
                params, _, _ = adamw_update(grads, st["opt"], st["params"], tcfg.optimizer)
                torch.cuda.synchronize()
                runs.append((loss, grads, params, _build.launches(), time.perf_counter() - t1))
                del st, grads, params
        (lk, gk, pk, nk, sk), (lp, gp, pp, np_, sp) = runs
        what = f"10b ({c.num_layers} layers, {batch['tokens'].numel()} tokens)"
        if nk != want or np_:
            raise AssertionError(f"{what}: kernel run launched {nk} (expected {want}), "
                                 f"plain run {np_}")
        if not (torch.isfinite(lk) and torch.equal(lk, lp)):
            raise AssertionError(f"{what}: loss {lk.item()} (kernels) vs {lp.item()} (plain)")
        equal_trees(gk, gp, f"{what} gradient")
        equal_trees(pk, pp, f"{what} updated parameter")
        out = {"batch": list(batch["tokens"].shape), "num_layers": c.num_layers,
               "loss": lk.item(), "kernel_launches": nk[key], "kernel_step_s": sk,
               "plain_step_s": sp, "leaves": len(flatten_with_paths(gk))}
        del runs, gk, gp, pk, pp
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    report["10b"] = {
        # full depth on one sequence, then the main path's rows (TRAIN_BATCH x
        # TRAIN_SEQ: m = 4,096 per projection) at LM_CUT_LAYERS layers
        "full_depth": kernels_vs_plain(cfg, {k: torch.from_numpy(v).to(dev) for k, v in
                                             dataclasses.replace(source, global_batch=1)
                                             .batch_at(DataState(0, 0)).items()}),
        "main_path_rows": kernels_vs_plain(cfg.with_(num_layers=LM_CUT_LAYERS), {
            k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(DataState(0, 0)).items()})}
    report["10b"]["phase_s"] = time.perf_counter() - t0
    log("[train 10b] " + json.dumps(report["10b"]) + ": in both, loss, every gradient leaf "
        "and every updated parameter torch.equal (kernels vs plain, deterministic algorithms)")

    # -- 10c. int8 moments + EF compression; microbatch 2 vs 1 ---------------
    t0 = time.perf_counter()
    t8 = TrainStepConfig(optimizer=dataclasses.replace(tcfg.optimizer, moments_dtype="int8"),
                         ef_compression=True)
    tr = trainer(cfg, t8, 2)
    rows8 = timed(tr)
    state, ds = tr.restore_or_init()
    mom_i8 = moment_bytes(state)
    res = tr.run(state, ds)
    check_steps(rows8, res.losses, "10c int8 + EF")
    del state, tr
    torch.cuda.empty_cache()
    # the reference's own check (tests/test_train_e2e.py) runs the bf16 policy:
    # under tnn each microbatch quantizes with its own per-tensor statistics
    bcfg = cfg.with_(quant_policy="bf16")
    first = {}
    for micro in (1, 2):
        tr = trainer(bcfg, dataclasses.replace(tcfg, microbatch=micro), 1)
        rows = timed(tr)
        first[micro] = tr.run().losses[0]
        check_steps(rows, [first[micro]], f"10c microbatch {micro}", want={})
        del tr
        torch.cuda.empty_cache()
    if not np.isclose(first[2], first[1], rtol=1e-4, atol=0):
        raise AssertionError(f"10c: microbatch=2 first loss {first[2]} vs {first[1]}")
    report["10c"] = {"int8_ef_losses": res.losses, "int8_ef_step_ms": [r[0] * 1e3 for r in rows8],
                     "moment_bytes_int8": mom_i8, "moment_bytes_f32": mom_f32,
                     "moment_ratio_f32_over_int8": mom_f32 / mom_i8,
                     "microbatch_first_loss": {"1": first[1], "2": first[2]},
                     "phase_s": time.perf_counter() - t0}
    log("[train 10c] " + json.dumps(report["10c"]))

    # -- 10d. resume on the card at LM_CUT_LAYERS layers ---------------------
    t0 = time.perf_counter()
    ccfg = cfg.with_(num_layers=LM_CUT_LAYERS)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="train_ck_"))
    try:
        with deterministic(torch):
            d = str(tmp / "ck")
            kw = dict(checkpoint_every=2, checkpoint_dir=d)
            full = trainer(ccfg, tcfg, 4, **kw).run()
            (tmp / "full").mkdir()
            shutil.move(str(tmp / "ck" / "step_000004"), str(tmp / "full" / "step_000004"))
            tr = trainer(ccfg, tcfg, 4, **kw)
            t1 = time.perf_counter()
            state, ds = tr.restore_or_init()
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t1
            if ds.step != 2 or int(state["opt"]["step"]) != 2:
                raise AssertionError(f"10d: restored {ds}, opt step {int(state['opt']['step'])}")
            resumed = tr.run(state, ds)
            if resumed.losses != full.losses[2:]:
                raise AssertionError(f"10d: resumed losses {resumed.losses} vs {full.losses[2:]}")
            del state, tr
            npz = [tmp / "full" / "step_000004" / "host_0.npz", tmp / "ck" / "step_000004" /
                   "host_0.npz"]
            with np.load(npz[0]) as a, np.load(npz[1]) as b:
                if sorted(a.files) != sorted(b.files):
                    raise AssertionError("10d: the two final checkpoints hold other leaves")
                for k in a.files:
                    if not np.array_equal(a[k], b[k]):
                        raise AssertionError(f"10d: final {k} differs from the uninterrupted run")
                n_leaves = len(a.files)
            # save and restore seconds of one checkpoint, outside the trainer
            target = trainer(ccfg, tcfg, 4).restore_or_init()[0]
            t1 = time.perf_counter()
            restored, _ = Checkpointer(CheckpointConfig(str(tmp / "full"))).restore(4, target)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            save_tree(str(tmp / "again"), 4, restored)
            save_s = time.perf_counter() - t1
            ck_bytes = npz[0].stat().st_size
            del restored, target
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    report["10d"] = {"num_layers": LM_CUT_LAYERS, "losses": full.losses,
                     "resumed_losses": resumed.losses, "checkpoint_bytes": ck_bytes,
                     "leaves": n_leaves, "save_s": save_s, "restore_s": restore_s,
                     "restore_or_init_s": resume_s, "phase_s": time.perf_counter() - t0}
    log("[train 10d] " + json.dumps(report["10d"]) + ": resumed losses and final state "
        "equal to the uninterrupted run's")

    # -- 10e. the entry point ------------------------------------------------
    t0 = time.perf_counter()
    _build.reset_launches()
    res = launch_train.main(["--arch", LM_ARCH, "--smoke", "--quant", "tnn", "--steps",
                             str(TRAIN_LAUNCH_STEPS), "--lr", "3e-3", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = _build.launches()
    from repro_torch.configs import get_smoke
    want = {key: TRAIN_LAUNCH_STEPS * tnn_gemms_per_forward(get_smoke(LM_ARCH)) *
            (2 if get_smoke(LM_ARCH).remat else 1)}
    if launches != want:
        raise AssertionError(f"10e: launch.train launched {launches}, expected {want}")
    add("10e", launches)
    head, tail = float(np.mean(res.losses[:5])), float(np.mean(res.losses[-5:]))
    if not (all(np.isfinite(res.losses)) and tail < head):
        raise AssertionError(f"10e: loss did not fall ({head} -> {tail})")
    report["10e"] = {"steps": res.final_step, "first5_mean": head, "last5_mean": tail,
                     "launches": launches, "s": time.perf_counter() - t0}
    log("[train 10e] " + json.dumps(report["10e"]))
    report["phase_s"] = time.perf_counter() - t_phase
    return report, launches10


def train_profile(torch, dev, step_ms):
    """Phase 10f: torch.profiler over one QAT step of 10a's configuration,
    after a warm-up step (run after phase 6, as 7d: a profiler session
    leaves later launches slower); busy share = device kernel time over
    10a's unprofiled host ms per step."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataState, SyntheticLM
    from repro_torch.models import ShardLayout
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig, init_train_state, make_train_step

    cfg = get_config(LM_ARCH, quant_policy="tnn")
    source = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, seed=0)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1))
    step = make_train_step(cfg, ShardLayout(), tcfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, ShardLayout(),
                             tcfg, device=dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                source.batch_at(DataState(i, 0)).items()} for i in range(2)]
    state, met = step(state, batches[0])
    float(met["loss"])
    rows, prof_ms = profiled(lambda: float(step(state, batches[1])[1]["loss"]))
    del state
    torch.cuda.empty_cache()
    dev_ms = sum(r[1] for r in rows)
    popc = sum(ms for n, ms, _ in rows if "lowbit_gemm_kernel" in n)
    floats = sum(ms for n, ms, _ in rows if "lowbit" not in n
                 and re.search(r"gemm|sm90_|cutlass|ampere", n, re.I))
    return {"device_kernel_ms": dev_ms, "host_ms_profiled": prof_ms,
            "host_ms_unprofiled": step_ms, "device_busy_share": dev_ms / step_ms,
            "popcount_gemm_ms": popc, "float_gemm_ms": floats,
            "other_kernels_ms": dev_ms - popc - floats, "kernels": sum(r[2] for r in rows),
            "top": [[n[:80], ms, calls] for n, ms, calls in rows[:12]]}


# ---------------------------------------------------------------------------
# Phase 11: the serving mesh (ranks started by phase11, run by mesh_rank)
# ---------------------------------------------------------------------------

def mesh_prompts(vocab: int):
    """Phase 11's requests: MESH_REQUESTS prompts of MESH_PROMPT token ids
    from numpy seed 11."""
    import numpy as np

    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, MESH_PROMPT).astype(np.int64)
            for _ in range(MESH_REQUESTS)]


def mesh_serve_config(mesh=None):
    """The ServeConfig of 11c/11d and of their single-device reference."""
    from repro_torch.serving import SamplerConfig, ServeConfig

    return ServeConfig(num_slots=MESH_REQUESTS, max_len=MESH_PROMPT + MESH_NEW,
                       prefill_bucket=MESH_PROMPT, sampler=SamplerConfig(temperature=0.0),
                       pack_params=True, mesh=mesh)


def mesh_engine(torch, dev, mesh):
    """TinyLlama-1.1B at full width and depth under ``tnn`` (phase 7a's
    weights), packed by an Engine on ``mesh`` (None: one device), after a
    warm-up request."""
    from repro_torch.configs import get_config
    from repro_torch.models import ShardLayout, model
    from repro_torch.serving import Engine

    cfg = get_config(LM_ARCH, quant_policy="tnn")
    gen = torch.Generator(device=dev).manual_seed(7)
    master = model.init_lm(gen, cfg, ShardLayout(), dtype=cfg.dtype, device=dev)
    t0 = time.perf_counter()
    eng = Engine(master, cfg, ShardLayout(), mesh_serve_config(mesh))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serve_run(torch, eng, mesh_prompts(cfg.vocab_size)[:1], 2)
    return eng, cfg, build_s


def plane_bytes(tree) -> int:
    """Bytes of the packed bit planes of every QTensor in ``tree``."""
    from repro_torch.kernels.qtensor import QTensor

    if isinstance(tree, QTensor):
        return sum(p.numel() * p.element_size() for p in tree.payload.values())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(plane_bytes(v) for v in tree)
    return 0


def mesh_counts(torch, fn):
    """(fn(), kernel launches, collectives) with both counters zeroed just
    before ``fn`` and read just after."""
    from repro_torch.kernels import _build
    from repro_torch.parallel import qmm_mesh

    torch.cuda.synchronize()
    _build.reset_launches()
    qmm_mesh.reset_collectives()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches(), qmm_mesh.collectives()


def mesh_qmm_checks(torch, dev, meshes):
    """11a: n-, k- and n+k-sharded qmm on every mesh, each mode, backends
    cuda and dense, at the GEMM_GRID diagonal (with a bias) and
    MESH_LM_SHAPES: ``torch.equal`` to the single-device qmm on the card
    and to the plain versions."""
    import collections

    import numpy as np
    from repro_torch.configs.paper_cnn import GEMM_GRID
    from repro_torch.kernels import ops
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.parallel import qmm_mesh, sharding

    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    grid = list(zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]))
    launches, coll, checked, plans = collections.Counter(), collections.Counter(), 0, {}
    for m, n, k in grid + MESH_LM_SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dev)
        bias = (torch.from_numpy(rng.standard_normal((n,), dtype=np.float32)).to(dev)
                if (m, n, k) in grid else None)
        for mode in MODES:
            qt = ops.pack_weights(w, QuantMode(mode)).replace(bias=bias)
            plain = ops.qmm(x, qt, backend="torch")
            for backend in ("cuda", "dense"):
                single = ops.qmm(x, qt, backend=backend)
                if not torch.equal(single, plain):
                    raise AssertionError(f"11a {mode} {backend} {m}x{n}x{k}: single-device "
                                         f"kernel differs from the plain version")
                for shape, mesh in meshes.items():
                    for label, pspec in MESH_CASES.items():
                        with sharding.use_mesh(mesh, sharding.SERVE_RULES_LOWBIT):
                            sq = qt.replace(pspec=pspec)
                            plan = qmm_mesh.shard_plan(sq)
                            if plan is None:
                                raise AssertionError(f"11a {shape} {label}: no shard plan")
                            local = qmm_mesh.take_local(sq)
                            got, ln, cl = mesh_counts(
                                torch, lambda: ops.qmm(x, local, backend=backend))
                        launches.update(ln)
                        coll.update(cl)
                        plans[f"{shape[0]}x{shape[1]}/{label}"] = [plan.n_axis, plan.k_axis]
                        if not torch.equal(got, single):
                            raise AssertionError(
                                f"11a {mode} {backend} {m}x{n}x{k} mesh {shape} {label}: "
                                f"sharded qmm differs from single-device (max abs "
                                f"{(got - single).abs().max().item()})")
                        checked += 1
    return {"checked": checked, "shapes": grid + MESH_LM_SHAPES, "plans": plans,
            "launches": dict(launches), "collectives": dict(coll),
            "s": time.perf_counter() - t0}


def mesh_conv_checks(torch, dev, meshes):
    """11b: cout-sharded qconv at every PAPER_CNN low-bit layer geometry
    (batch 8), each mode, backends cuda and dense, on every mesh:
    ``torch.equal`` to the single-device qconv."""
    import collections

    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.conv import pack_conv_filters
    from repro_torch.kernels import ops
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.parallel import qmm_mesh, sharding

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    geoms, hw, c_in = [], PAPER_CNN.img_size, PAPER_CNN.c_in
    for spec in PAPER_CNN.convs:
        if spec.mode != "bf16":
            geoms.append(((8, hw, hw, c_in), (spec.kernel, spec.kernel, c_in, spec.c_out),
                          spec.stride))
        hw = hw // 2 if spec.pool else hw
        c_in = spec.c_out
    launches, coll, checked = collections.Counter(), collections.Counter(), 0
    for xs, fs, stride in geoms:
        x = torch.randn(xs, generator=gen, device=dev)
        f = torch.randn(fs, generator=gen, device=dev)
        bias = torch.randn((fs[-1],), generator=gen, device=dev)
        for mode in MODES:
            qt = pack_conv_filters(f, QuantMode(mode), bias=bias)
            for backend in ("cuda", "dense"):
                single = ops.qconv(x, qt, stride=stride, backend=backend)
                for shape, mesh in meshes.items():
                    with sharding.use_mesh(mesh, sharding.SERVE_RULES_LOWBIT):
                        local = qmm_mesh.take_local(qt.replace(pspec=("model", None)))
                        got, ln, cl = mesh_counts(
                            torch, lambda: ops.qconv(x, local, stride=stride, backend=backend))
                    launches.update(ln)
                    coll.update(cl)
                    if not torch.equal(got, single):
                        raise AssertionError(f"11b {mode} {backend} x{xs} f{fs} mesh {shape}: "
                                             f"sharded qconv differs from single-device")
                    checked += 1
    return {"checked": checked, "geometries": [[list(a), list(b), c] for a, b, c in geoms],
            "launches": dict(launches), "collectives": dict(coll),
            "s": time.perf_counter() - t0}


def mesh_expect(cfg, forwards: int, fused: int, i32: int, gathers: int):
    """The launches and collectives a mesh run of ``forwards`` forwards
    must show: per layer ``fused`` fused and ``i32`` int32 TNN GeMMs, one
    all-reduce per int32 GeMM, ``gathers`` gathers."""
    n = cfg.num_layers * forwards
    launches = {k: v for k, v in (("lowbit_gemm_tnn_fused", fused * n),
                                  ("lowbit_gemm_tnn_i32", i32 * n)) if v}
    return launches, {"all_reduce": i32 * n, "all_gather": gathers * n}


def mesh_check_counts(what, launches, coll, want):
    want_l, want_c = want
    got_c = {k: coll.get(k, 0) for k in want_c}
    if launches != want_l or got_c != want_c:
        raise AssertionError(f"{what}: launches {launches}, collectives {coll}; expected "
                             f"{want_l} and {want_c}")


def mesh_engine_11c(torch, dev, mesh):
    """11c: the mesh Engine on (1, 4); 5 n-sharded fused and 2 k-sharded
    int32 TNN GeMMs (and 2 all-reduces) per layer per forward."""
    t0 = time.perf_counter()
    eng, cfg, build_s = mesh_engine(torch, dev, mesh)
    prompts = mesh_prompts(cfg.vocab_size)
    run, launches, coll = mesh_counts(torch, lambda: serve_run(torch, eng, prompts, MESH_NEW))
    results, secs, ttft, itl, calls = run
    forwards = calls["prefill"] + calls["decode"]
    mesh_check_counts("11c", launches, coll, mesh_expect(cfg, forwards, 5, 2, 5))
    report = {
        "mesh": list(mesh.shape), "backend": mesh.backend, "build_and_pack_s": build_s,
        "tokens": {u: [r.status, r.tokens] for u, r in results.items()},
        "forwards": forwards, "calls": calls, "launches": launches, "collectives": coll,
        "per_forward": {"fused": launches["lowbit_gemm_tnn_fused"] // forwards,
                        "i32": launches["lowbit_gemm_tnn_i32"] // forwards,
                        "all_reduce": coll["all_reduce"] // forwards},
        "plane_bytes_local": plane_bytes(eng.params), "run_s": secs,
        "collective_s": coll.get("all_reduce_s", 0.0) + coll.get("all_gather_s", 0.0),
        "collective_share": (coll.get("all_reduce_s", 0.0) + coll.get("all_gather_s", 0.0))
        / secs,
        "generated_tokens_per_s": sum(len(r.tokens) for r in results.values()) / secs,
        "prefill_tokens_per_s": MESH_REQUESTS * MESH_PROMPT / max(ttft),
        "ttft_s": percentiles(ttft), "inter_token_s": percentiles(itl),
        "s": time.perf_counter() - t0}
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return report


def mesh_engine_11d(torch, dev, mesh):
    """11d: the mesh Engine on (2, 2) for one tick (the requests in
    flight), a fake-clock watchdog that hears from every rank but the
    last, ``rebuild_after_loss`` of that rank, and the migrated requests
    served on the rebuilt (1, 2) mesh."""
    from repro_torch.runtime.fault_tolerance import WatchdogConfig
    from repro_torch.serving import Request

    t0 = time.perf_counter()
    eng, cfg, _ = mesh_engine(torch, dev, mesh)
    calls = {"prefill": 0, "decode": 0}
    real_prefill, real_step = eng.prefill, eng.serve_step

    def count(fn, what):
        def call(*a, **k):
            calls[what] += 1
            return fn(*a, **k)
        return call

    eng.prefill, eng.serve_step = count(real_prefill, "prefill"), count(real_step, "decode")
    for uid, p in enumerate(mesh_prompts(cfg.vocab_size)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=MESH_NEW))
    _, launches, coll = mesh_counts(torch, eng.step)
    forwards = calls["prefill"] + calls["decode"]
    # (2, 2) under serve_lowbit: wq/wk/wv n over model + k over data, wo/down
    # k over model, gate/up n over model (their stacked planes match the
    # reference's 3-D expert rule first, which has no k axis)
    mesh_check_counts("11d (2, 2)", launches, coll, mesh_expect(cfg, forwards, 2, 5, 5))
    in_flight = sorted(r.uid for r in eng._sched.unfinished())
    if len(in_flight) != MESH_REQUESTS:
        raise AssertionError(f"11d: {in_flight} in flight after one tick")
    t = [0.0]
    wd = eng.make_watchdog(WatchdogConfig(dead_after_s=5.0), clock=lambda: t[0])
    for h in range(mesh.size - 1):
        wd.heartbeat(h, 0.1)
    t[0] = 10.0
    for h in range(mesh.size - 1):
        wd.heartbeat(h, 0.1)
    dead = wd.check().dead
    if dead != [mesh.size - 1]:
        raise AssertionError(f"11d: the watchdog flagged {dead}")
    t1 = time.perf_counter()
    new = eng.rebuild_after_loss([int(mesh.devices.flat[h]) for h in dead])
    rebuild_s = time.perf_counter() - t1
    report = {"mesh": list(mesh.shape), "forwards_before": forwards,
              "launches_before": launches, "collectives_before": coll,
              "per_forward_before": {"fused": launches["lowbit_gemm_tnn_fused"] // forwards,
                                     "i32": launches["lowbit_gemm_tnn_i32"] // forwards,
                                     "all_reduce": coll["all_reduce"] // forwards},
              "in_flight": in_flight, "dead": dead, "rebuild_s": rebuild_s,
              "plane_bytes_local": plane_bytes(eng.params), "rebuilt": None}
    eng.close()
    if new is not None:
        calls = {"prefill": 0, "decode": 0}
        new.prefill = count(new.prefill, "prefill")
        new.serve_step = count(new.serve_step, "decode")
        results, launches, coll = mesh_counts(torch, new.run)
        forwards = calls["prefill"] + calls["decode"]
        mesh_check_counts("11d (1, 2)", launches, coll, mesh_expect(cfg, forwards, 5, 2, 5))
        report["rebuilt"] = {
            "mesh": list(new.scfg.mesh.shape), "ranks": new.scfg.mesh.devices.ravel().tolist(),
            "tokens": {u: [r.status, r.tokens] for u, r in results.items()},
            "forwards": forwards, "launches": launches, "collectives": coll}
        new.close()
    del eng, new
    torch.cuda.empty_cache()
    report["s"] = time.perf_counter() - t0
    return report


def mesh_rank(torch, out_dir: str) -> int:
    """One rank of phase 11 (``--mesh-rank``): joins the world, builds the
    meshes, runs 11a-11d and writes ``rank<r>.json`` into ``out_dir``.
    Any failure raises (a non-zero exit the parent reports)."""
    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.tune import cache as plan_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.init_rank("cuda")
    rank = dist.get_rank()
    plan_cache.set_cache_path(os.path.join(out_dir, f"plans_rank{rank}.json"))
    obs.set_enabled(True)
    meshes = {shape: mesh_mod.make_serve_mesh(model=shape[1], data=shape[0], device=dev)
              for shape in MESH_SHAPES}
    log(f"[mesh] rank {rank}: " + "; ".join(repr(m) for m in meshes.values()))
    report = {"rank": rank, "backend": meshes[MESH_SHAPES[0]].backend}
    for name, fn in (("11a", lambda: mesh_qmm_checks(torch, dev, meshes)),
                     ("11b", lambda: mesh_conv_checks(torch, dev, meshes)),
                     ("11c", lambda: mesh_engine_11c(torch, dev, meshes[(1, 4)])),
                     ("11d", lambda: mesh_engine_11d(torch, dev, meshes[(2, 2)]))):
        report[name] = fn()
        log(f"[mesh {name}] rank {rank} done in {report[name]['s']:.1f} s")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    mesh_mod.shutdown()
    return 0


def phase11(torch, dev):
    """Phase 11 (see the module docstring): the single-device reference
    tokens, then MESH_WORLD ranks of ``--mesh-rank`` sharing the card over
    gloo; every rank must exit 0 and the parent checks what they report.
    Returns (the report, {kernel: {sub-phase: rank 0's launches}})."""
    import shutil

    from repro_torch.launch import mesh as mesh_mod

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # the single-device reference: the same weights, config and requests
    eng, cfg, build_s = mesh_engine(torch, dev, None)
    results, secs, ttft, itl, calls = serve_run(torch, eng, mesh_prompts(cfg.vocab_size),
                                                MESH_NEW)
    single = {str(u): [r.status, r.tokens] for u, r in results.items()}
    if not all(r.status == "ok" and len(r.tokens) == 1 + MESH_NEW for r in results.values()):
        raise AssertionError(f"phase 11 single-device run: {single}")
    single_bytes = plane_bytes(eng.params)
    ref = {"tokens_per_s": sum(len(r.tokens) for r in results.values()) / secs,
           "prefill_tokens_per_s": MESH_REQUESTS * MESH_PROMPT / max(ttft),
           "inter_token_s": percentiles(itl), "plane_bytes": single_bytes,
           "build_and_pack_s": build_s}
    eng.close()
    del eng
    torch.cuda.empty_cache()

    out_dir = ROOT / "build" / "chip_smoke" / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    res = mesh_mod.run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                              str(out_dir)], MESH_WORLD, timeout_s=MESH_TIMEOUT_S,
                             log_dir=str(out_dir / "logs"))
    ranks_s = time.perf_counter() - t0
    with open(res[0]["log"]) as f:
        for line in f:
            if line.startswith("[mesh"):
                log(line.rstrip())
    if any(r["returncode"] != 0 for r in res):
        raise AssertionError("phase 11: a mesh rank failed or overran\n"
                             + mesh_mod.rank_logs(res))
    reps = [json.load(open(out_dir / f"rank{r}.json")) for r in range(MESH_WORLD)]
    for rep in reps:
        r = rep["rank"]
        if rep["11c"]["tokens"] != single:
            raise AssertionError(f"11c rank {r}: mesh tokens differ from single-device")
        ratio = rep["11c"]["plane_bytes_local"] / single_bytes
        if abs(ratio - 0.25) > 1e-12:
            raise AssertionError(f"11c rank {r}: local plane bytes {ratio} of single-device")
        new = rep["11d"]["rebuilt"]
        if r < 2:
            if new is None or new["mesh"] != [1, 2] or new["tokens"] != single:
                raise AssertionError(f"11d rank {r}: rebuilt run {new}")
        elif new is not None:
            raise AssertionError(f"11d rank {r} should have left the mesh: {new}")
    r0 = reps[0]
    report = {"single_device": ref, "ranks_s": ranks_s, "world": MESH_WORLD,
              "backend": r0["backend"], "11a": r0["11a"], "11b": r0["11b"],
              "11c": r0["11c"], "11d": r0["11d"],
              "11c_rank_run_s": [rep["11c"]["run_s"] for rep in reps],
              "11c_rank_collective_share": [rep["11c"]["collective_share"] for rep in reps],
              "11c_plane_bytes_ratio": r0["11c"]["plane_bytes_local"] / single_bytes,
              "11d_plane_bytes_ratio": r0["11d"]["plane_bytes_local"] / single_bytes,
              "phase_s": time.perf_counter() - t_phase}
    launches = {}
    for sub, counts in (("11a", r0["11a"]["launches"]), ("11b", r0["11b"]["launches"]),
                        ("11c", r0["11c"]["launches"]),
                        ("11d", r0["11d"]["launches_before"])):
        for k, v in counts.items():
            launches.setdefault(k, {})[sub] = v
    for k in ("lowbit_gemm_tnn_fused", "lowbit_gemm_tnn_i32"):
        if not launches.get(k, {}).get("11c"):
            raise AssertionError(f"phase 11c launched no {k}")
    return report, launches


# ---------------------------------------------------------------------------
# Phase 12: the training mesh (ranks started by phase12, run by
# train_mesh_rank)
# ---------------------------------------------------------------------------

def train_mesh_config(num_layers=None, policy="tnn"):
    """12a's configuration: TinyLlama-1.1B (or its first ``num_layers``
    layers) under ``policy`` with remat, AdamW with int8 moments, EF on,
    the bf16 wire; TRAIN_BATCH x TRAIN_SEQ tokens a step from SyntheticLM
    seed 0.  -> (cfg, tcfg, source)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig

    cfg = get_config(LM_ARCH, quant_policy=policy)
    if num_layers:
        cfg = cfg.with_(num_layers=num_layers)
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR, warmup_steps=1,
                                                 moments_dtype="int8"), ef_compression=True)
    return cfg, tcfg, SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0)


def plane_digest(torch, t) -> int:
    """A checksum of an int32 plane (int64 sums wrap the same way on any
    order): the first forward's planes are compared by it."""
    w = torch.arange(t.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int((t.reshape(-1).to(torch.int64) * w).sum().item())


@contextlib.contextmanager
def record_planes(torch, box, n_keep: int, n_forward: int):
    """While active, the first ``n_forward`` low-bit ``qmm`` calls (the
    first forward's projections): each call's planes' digests, and the
    first ``n_keep`` calls' planes themselves (on the host) and operands
    (``x``, the packed weight, the activation statistics the call was
    given: a split batch's global ones on the mesh), for
    :func:`operands_vs_plain`."""
    from repro_torch.kernels import ops

    real = ops.qmm
    box.setdefault("digests", [])
    box.setdefault("planes", [])
    box.setdefault("operands", [])

    def qmm(x, qt, *, backend=None, act_stats=None):
        if qt.mode.is_lowbit and len(box["digests"]) < n_forward:
            box["digests"].append([plane_digest(torch, qt.payload[k])
                                   for k in sorted(qt.payload)])
            if len(box["planes"]) < n_keep:
                box["planes"].append({k: v.cpu() for k, v in qt.payload.items()})
                box["operands"].append((x.detach().clone(), qt, act_stats))
        return real(x, qt, backend=backend, act_stats=act_stats)

    ops.qmm = qmm
    try:
        yield box
    finally:
        ops.qmm = real


def operands_vs_plain(torch, operands) -> dict:
    """Row 1 against its plain version at the main path's own operands:
    each kept projection's ``qmm`` on the card's kernel and with
    ``backend="torch"``, ``torch.equal``, with the (m, n, k) it ran at.
    Called outside the counted window."""
    from repro_torch.kernels import ops

    out = {"shapes": [], "equal": [], "max_abs_err": 0.0}
    with deterministic(torch):
        for x, qt, stats in operands:
            got = ops.qmm(x, qt, act_stats=stats)
            want = ops.qmm(x, qt, backend="torch", act_stats=stats)
            out["shapes"].append([int(x.shape[0]), int(qt.shape[1]), int(qt.shape[0])])
            out["equal"].append(bool(torch.equal(got, want)))
            out["max_abs_err"] = max(out["max_abs_err"], float((got - want).abs().max()))
    return out


def leaf_sumsq(torch, state, shardings=None, mesh=None):
    """{path: sum of squares} of every float leaf of ``state["params"]``:
    on a mesh each shard counted once (``sharding.holds_first_copy``; one
    all-reduce)."""
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten_with_paths

    flat = flatten_with_paths(state["params"])
    vals = torch.stack([torch.sum(torch.square(t.to(torch.float64))) for _, t in flat])
    if mesh is not None:
        sh = dict(flatten_with_paths(shardings["params"]))
        keep = [sharding.holds_first_copy(sh[path].spec, mesh) for path, _ in flat]
        vals = mesh.all_reduce_(vals * torch.tensor(keep, dtype=vals.dtype, device=vals.device))
    return {path: float(v) for (path, _), v in zip(flat, vals.tolist())}


def train_mesh_collectives(cfg, tcfg, sh, mesh, policy) -> dict:
    """The training mesh's collectives per rank per step, predicted from
    the state's shardings ``sh`` and the rules (each counted once per mesh
    axis of size > 1 it runs over, as ``launch.mesh.collectives`` counts
    them): a gather per sharded axis of every sharded leaf and a
    reduce-scatter per batch axis among them; all-reduces: the batch axes
    a sharded leaf's spec does not use, every replicated leaf's gradient,
    each low-bit projection's statistics (2 sums for tnn/tbn, 1 for bnn)
    in the forward and in the remat recompute, the loss's token count and
    the loss shares, the global norm and EF's absmax (one each over the
    whole mesh), and an int8 moment whose shard cuts a 256-block: its
    block maxima (all-reduce) and its scales (gather), for m and v."""
    from repro_torch.optim.adamw import Q8Layout
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten_with_paths

    def n(axes):
        return sum(1 for a in axes if mesh.axis_size(a) > 1)

    batch = [a for a in sharding.batch_axes() if mesh.axis_size(a) > 1]
    micro = tcfg.microbatch
    gathers = scatters = reduces = 0
    opt_m = dict(flatten_with_paths(sh["opt"]["m"]))
    for path, p in flatten_with_paths(sh["params"]):
        used = {a for e in p.spec for a in sharding.spec_axes(e)}
        if p.sharded:
            gathers += micro * n(used)
            scatters += micro * n([a for a in batch if a in used])
            reduces += micro * n([a for a in batch if a not in used])
        else:
            reduces += n(batch)
        if tcfg.optimizer.moments_dtype == "int8" and Q8Layout.cuts(p, mesh):
            reduces += 2 * n(sharding.spec_axes(p.spec[-1]))
            gathers += 2 * n(sharding.spec_axes(opt_m[f"{path}/scale"].spec[-1]))
    stats = {"tnn": 2, "tbn": 2, "bnn": 1}.get(policy, 0)
    forwards = 2 if cfg.remat else 1
    reduces += micro * n(batch) * (stats * forwards * tnn_gemms_per_forward(cfg) + 1)
    reduces += n(batch) + (1 if mesh.size > 1 else 0) * (1 + int(tcfg.ef_compression))
    return {"all_gather": gathers, "reduce_scatter": scatters, "all_reduce": reduces}


def state_bytes(state) -> dict:
    """Bytes of masters, moments and EF buffers."""
    from repro_torch.tree import flatten_with_paths

    out = {}
    for path, t in flatten_with_paths(state):
        group = "moments" if path.startswith("opt/") else path.split("/")[0]
        out[group] = out.get(group, 0) + t.numel() * t.element_size()
    return out


def train_mesh_trainer(torch, dev, cfg, tcfg, source, layout, rows, box, kept, mesh=None):
    """A Trainer of 12a's configuration whose step is instrumented: host
    clock around each synchronized step, the launch and collective
    counters zeroed just before it and read just after, then (outside the
    window) the metrics and every leaf's sum of squares into ``rows`` and
    the state into ``kept["state"]``; the first step's forward recorded
    into ``box``."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_paths

    tr = Trainer(cfg, layout, tcfg, TrainerConfig(steps=TRAIN_MESH_STEPS, log_every=10**9),
                 source, device=dev, log_fn=log)
    inner = tr.step_fn

    def step(state, batch):
        torch.cuda.synchronize()
        _build.reset_launches()
        mesh_mod.reset_collectives()
        t0 = time.perf_counter()
        if not rows:
            with record_planes(torch, box, 7, tnn_gemms_per_forward(cfg)):
                out = inner(state, batch)
        else:
            out = inner(state, batch)
        float(out[1]["loss"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, coll = _build.launches(), mesh_mod.collectives()
        kept["state"] = out[0]
        if not rows and kept.get("snapshot"):
            kept["params_after_first"] = {p: t.clone() for p, t in
                                          flatten_with_paths(out[0]["params"])}
        rows.append({"s": secs, "launches": launches, "collectives": coll,
                     "metrics": {k: float(v) for k, v in out[1].items()},
                     "sumsq": leaf_sumsq(torch, out[0], tr.shardings, mesh)})
        return out

    tr.step_fn = step
    return tr


def train_mesh_rank(torch, out_dir: str) -> int:
    """One rank of phase 12 (``--train-mesh-rank``): 12a on (2, 2) at full
    depth and at LM_CUT_LAYERS, 12b at LM_CUT_LAYERS; writes
    ``rank<r>.json`` into ``out_dir``.  Any failure raises."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.data import DataState, make_pipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import ShardLayout
    from repro_torch.parallel import sharding
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten_with_paths, map_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.init_rank("cuda")
    rank = dist.get_rank()
    mesh = mesh_mod.make_mesh(TRAIN_MESH_SHAPE, ("data", "model"), device=dev)
    mesh41 = mesh_mod.make_mesh((mesh.size, 1), ("data", "model"), device=dev)
    log(f"[train mesh] rank {rank}: {mesh!r}")
    report = {"rank": rank, "backend": mesh.backend}
    single = torch.load(os.path.join(out_dir, "single.pt"), weights_only=False)
    tp = dict(zip(mesh.axis_names, mesh.shape))["model"]

    # -- 12a: full width and depth, then LM_CUT_LAYERS layers -------------------
    for name, layers, policy in TRAIN_MESH_RUNS:
        cfg, tcfg, source = train_mesh_config(layers, policy)
        state = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows, box, kept = [], {}, {"snapshot": name == "12a_cut"}
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            tr = train_mesh_trainer(torch, dev, cfg, tcfg, source, ShardLayout(tp=tp), rows,
                                    box, kept, mesh)
            expect = train_mesh_collectives(cfg, tcfg, tr.shardings, mesh, policy)
            state, ds = tr.restore_or_init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            nbytes = state_bytes(state)
            res = tr.run(state, ds)
        del state
        peak = torch.cuda.max_memory_allocated()
        ref = single[name]
        report[name] = {
            "rows": rows, "losses": res.losses, "init_s": init_s, "peak_memory_bytes": peak,
            "collectives_expected": expect, "vs_plain": operands_vs_plain(torch, box["operands"]),
            "bytes": nbytes, "coords": mesh.coords, "n_digests": len(box["digests"]),
            "digests": box["digests"],
            "digests_equal": box["digests"] == ref["digests"],
            "planes_equal": len(box["planes"]) == len(ref["planes"]) and all(
                torch.equal(a[k], b[k]) for a, b in zip(box["planes"], ref["planes"])
                for k in a)}
        del box
        if name == "12a_cut":
            cut = kept, tr.shardings, cfg, tcfg, source
        log(f"[train mesh {name}] rank {rank}: steps {[round(r['s'], 3) for r in rows]} s, "
            f"losses {res.losses}, peak {peak / 2**30:.2f} GiB")
    kept, sh, cfg, tcfg, source = cut
    state = kept["state"]
    by = dict(flatten_with_paths(sh))
    # 12a_cut: every master after the first step elementwise against one
    # device's (its whole leaves, mapped, one at a time)
    whole = torch.load(os.path.join(out_dir, "single_cut_params.pt"), mmap=True,
                       weights_only=False)
    worst, moved, count = 0.0, 0, 0
    for path, t in kept["params_after_first"].items():
        want = sharding.shard_leaf(whole[path], by["params/" + path].spec, mesh).to(dev)
        d = (t - want).abs()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-3 * TRAIN_MESH_LR).sum())
        count += t.numel()
    del whole, kept["params_after_first"]
    report["12a_cut"]["elementwise"] = {"max_abs_diff": worst, "bound": 2 * TRAIN_MESH_LR,
                                        "moved_more_than_1e-3_lr": moved, "elements": count}
    # -- 12b: save on (2, 2), restore onto (4, 1) -----------------------------------
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.train_step import state_shardings

    ck_dir = os.path.join(out_dir, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        Checkpointer(CheckpointConfig(ck_dir, async_save=False)).save(
            TRAIN_MESH_STEPS, state, extra={"data_state": {"step": TRAIN_MESH_STEPS, "seed": 0}},
            shardings=sh)
    save_s = time.perf_counter() - t0
    with sharding.use_mesh(mesh41, sharding.TRAIN_RULES):
        sh41 = state_shardings(cfg, ShardLayout(tp=1), tcfg)
        by41 = dict(flatten_with_paths(sh41))
        target = Trainer(cfg, ShardLayout(tp=1), tcfg, TrainerConfig(steps=1), source,
                         device=dev, log_fn=log).restore_or_init()[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, extra = Checkpointer(CheckpointConfig(ck_dir)).restore(
            TRAIN_MESH_STEPS, target, shardings=sh41)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # the saved state re-sharded in memory, leaf by leaf
        live = dict(flatten_with_paths(state))
        direct = map_with_paths(lambda p, _: sharding.shard_leaf(
            by[p].gather(live[p], mesh), by41[p].spec, mesh41), target)
        del live, state, target
        equal = all(torch.equal(x, y) for (_, x), (_, y) in
                    zip(flatten_with_paths(restored), flatten_with_paths(direct)))
        step = make_train_step(cfg, ShardLayout(tp=1), tcfg)
        coord, shards = sharding.mesh_coord(mesh41, sharding.batch_axes())
        _, batch = next(make_pipeline(source, DataState(TRAIN_MESH_STEPS, 0), host_id=coord,
                                      num_hosts=shards))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with deterministic(torch):
            a, ma = step(restored, batch)
            b, mb = step(direct, batch)
            resume_equal = float(ma["loss"]) == float(mb["loss"]) and all(
                torch.equal(x, y) for (_, x), (_, y) in
                zip(flatten_with_paths(a), flatten_with_paths(b)))
    report["12b"] = {"save_s": save_s, "restore_s": restore_s, "restored_equal": equal,
                     "resume_equal": resume_equal, "extra": extra,
                     "loss_after_restore": float(ma["loss"])}
    log(f"[train mesh 12b] rank {rank}: save {save_s:.2f} s, restore {restore_s:.2f} s, "
        f"restored == saved {equal}, resumed == uninterrupted {resume_equal}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    mesh.barrier()
    mesh_mod.shutdown()
    return 0


def train_mesh_single(torch, dev, name, layers, policy, out_dir):
    """A run of TRAIN_MESH_RUNS on one device (the reference of the mesh
    run): the instrumented rows, the first forward's planes, peak memory,
    bytes; for "12a_cut" the masters after the first step too."""
    from repro_torch.models import ShardLayout

    cfg, tcfg, source = train_mesh_config(layers, policy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows, box, kept = [], {}, {"snapshot": name == "12a_cut"}
    tr = train_mesh_trainer(torch, dev, cfg, tcfg, source, ShardLayout(), rows, box, kept)
    state, ds = tr.restore_or_init()
    nbytes = state_bytes(state)
    # the loss and gradient norm (before EF) of one device on the first
    # batch, its rows in order and reversed: how far the device's own float
    # sums move the QAT step
    from repro_torch.data import DataState
    from repro_torch.train.train_step import make_loss_fn

    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.train_step import value_and_grad

    loss_fn = make_loss_fn(cfg, ShardLayout(), tcfg)
    b0 = {k: torch.from_numpy(v).to(dev) for k, v in source.batch_at(DataState(0, 0)).items()}
    probe = []
    for b in (b0, {k: v.flip(0) for k, v in b0.items()}):
        (loss, _), grads = value_and_grad(loss_fn, state["params"], b)
        probe.append((float(loss), float(global_norm(grads))))
        del grads
    torch.cuda.empty_cache()
    noise = {"loss": probe[0][0], "loss_rows_reversed": probe[1][0],
             "rel": abs(probe[1][0] / probe[0][0] - 1), "grad_norm": probe[0][1],
             "grad_norm_rows_reversed": probe[1][1],
             "grad_norm_rel": abs(probe[1][1] / probe[0][1] - 1)}
    res = tr.run(state, ds)
    out = {"rows": rows, "losses": res.losses, "peak_memory_bytes":
           torch.cuda.max_memory_allocated(), "bytes": nbytes, "digests": box["digests"],
           "planes": box["planes"], "order_noise": noise,
           "vs_plain": operands_vs_plain(torch, box.pop("operands"))}
    if name == "12a_cut":
        torch.save({p: t.cpu() for p, t in kept["params_after_first"].items()},
                   os.path.join(out_dir, "single_cut_params.pt"))
    del state, kept, tr
    torch.cuda.empty_cache()
    return out


def phase12(torch, dev):
    """Phase 12 (see the module docstring): the single-device reference
    runs, then TRAIN_MESH_WORLD ranks of ``--train-mesh-rank`` sharing the
    card over gloo (one card each over NCCL where the machine has them),
    then ``launch.train`` on 4 ranks.  Returns (the report, {kernel:
    {sub-phase: rank 0's launches per step}})."""
    import shutil

    import numpy as np

    from repro_torch.launch import mesh as mesh_mod

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "train_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    key = LM_POLICY_KERNELS["tnn"]
    single = {name: train_mesh_single(torch, dev, name, layers, policy, str(out_dir))
              for name, layers, policy in TRAIN_MESH_RUNS}
    torch.save(single, out_dir / "single.pt")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.setdefault("OMP_NUM_THREADS", "2")      # 4 ranks on the host's 8 cores
    res = mesh_mod.run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--train-mesh-rank",
                              str(out_dir)], TRAIN_MESH_WORLD, timeout_s=TRAIN_MESH_TIMEOUT_S,
                             env=env, log_dir=str(out_dir / "logs"))
    ranks_s = time.perf_counter() - t0
    with open(res[0]["log"]) as f:
        for line in f:
            if line.startswith("[train mesh") or line.startswith("[mesh]"):
                log(line.rstrip())
    if any(r["returncode"] != 0 for r in res):
        raise AssertionError("phase 12: a training-mesh rank failed or overran\n"
                             + mesh_mod.rank_logs(res))
    reps = [json.load(open(out_dir / f"rank{r}.json")) for r in range(TRAIN_MESH_WORLD)]
    failures, diag = [], []
    for rep in reps:
        r = rep["rank"]
        for name, layers, policy in TRAIN_MESH_RUNS:
            # the remat recompute doubles the forward's launches
            n_fwd = tnn_gemms_per_forward(train_mesh_config(layers)[0]) if policy == "tnn" \
                else 0
            want = {key: 2 * n_fwd} if n_fwd else {}
            got, ref = rep[name], single[name]
            for i, (row, srow) in enumerate(zip(got["rows"], ref["rows"])):
                m, sm = row["metrics"], srow["metrics"]
                tol = TRAIN_MESH_BOUNDS[name][i]
                d_loss = abs(m["loss"] / sm["loss"] - 1)
                d_gn = abs(m["grad_norm"] / sm["grad_norm"] - 1)
                d_sq = max(abs(row["sumsq"][p] / v - 1) for p, v in srow["sumsq"].items())
                diag.append(f"{name} rank {r} step {i}: loss {m['loss']} vs {sm['loss']} "
                            f"({d_loss:.2e}), grad_norm ({d_gn:.2e}), sums of squares "
                            f"(max {d_sq:.2e})")
                if row["launches"] != want:
                    failures.append(f"{name} rank {r} step {i}: launched {row['launches']}, "
                                    f"expected {want}")
                coll = {k: row["collectives"].get(k, 0) for k in got["collectives_expected"]}
                if coll != got["collectives_expected"]:
                    failures.append(f"{name} rank {r} step {i}: collectives {coll}, expected "
                                    f"{got['collectives_expected']}")
                if d_loss > tol["loss"] or d_gn > tol["grad_norm"] or (
                        tol["sumsq"] is not None and d_sq > tol["sumsq"]):
                    failures.append(f"{name} rank {r} step {i}: outside {tol}")
            first = next((k for k, (x, y) in enumerate(zip(got["digests"], ref["digests"]))
                          if x != y), None)
            diag.append(f"{name} rank {r}: {got['n_digests']} projections, first differing "
                        f"planes at {first}; first layer's planes equal {got['planes_equal']}")
            if not (got["digests_equal"] and got["planes_equal"]):
                failures.append(f"{name} rank {r}: the first forward's planes differ from one "
                                f"device's (first at projection {first})")
            if got["n_digests"] != n_fwd:
                failures.append(f"{name} rank {r}: {got['n_digests']} projections in the "
                                f"first forward")
            vp = got["vs_plain"]
            diag.append(f"{name} rank {r}: row 1 vs plain at the first forward's operands "
                        f"{vp['shapes']}: {vp['equal']}")
            if len(vp["equal"]) != min(n_fwd, 7) or not all(vp["equal"]):
                failures.append(f"{name} rank {r}: row 1 differs from its plain version at the "
                                f"mesh's operands: {vp}")
        el = rep["12a_cut"]["elementwise"]
        diag.append(f"12a_cut rank {r} masters after step 1: {el}")
        if el["max_abs_diff"] > el["bound"] + 1e-6:
            failures.append(f"12a_cut rank {r}: a master after the first step differs from "
                            f"one device's by more than 2 lr: {el}")
        if el["moved_more_than_1e-3_lr"] > TRAIN_MESH_MOVED_MAX * el["elements"]:
            failures.append(f"12a_cut rank {r}: more than {TRAIN_MESH_MOVED_MAX} of the "
                            f"masters moved by more than 1e-3 lr from one device's: {el}")
        b = rep["12b"]
        if not (b["restored_equal"] and b["resume_equal"]):
            failures.append(f"12b rank {r}: {b}")
    for name, layers, policy in TRAIN_MESH_RUNS:
        diag.append(f"{name} one device, the loss and grad norm with the rows reversed: "
                    f"{single[name]['order_noise']}")
        vp = single[name]["vs_plain"]
        if policy == "tnn" and (len(vp["equal"]) != 7 or not all(vp["equal"])):
            failures.append(f"{name} one device: row 1 differs from its plain version: {vp}")
    for line in diag:
        log("[train mesh check] " + line)
    if failures:
        raise AssertionError("phase 12:\n" + "\n".join(failures))
    r0 = reps[0]
    a, sa = r0["12a"], single["12a"]
    step_s = a["rows"][-1]["s"]
    coll = a["rows"][-1]["collectives"]
    coll_s = sum(v for k, v in coll.items() if k.endswith("_s"))
    f32_gather = sum(v * (2 if k.endswith("bfloat16") else 1) for k, v in coll.items()
                     if k.startswith("all_gather_bytes_"))
    report = {
        "world": TRAIN_MESH_WORLD, "backend": r0["backend"], "mesh": list(TRAIN_MESH_SHAPE),
        "ranks_s": ranks_s,
        "12a": {"losses": a["losses"], "single_losses": sa["losses"],
                "grad_norms": [row["metrics"]["grad_norm"] for row in a["rows"]],
                "single_grad_norms": [row["metrics"]["grad_norm"] for row in sa["rows"]],
                "step_s": [row["s"] for row in a["rows"]],
                "rank_step_s": [[row["s"] for row in rep["12a"]["rows"]] for rep in reps],
                "single_step_s": [row["s"] for row in sa["rows"]],
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
                "single_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / sa["rows"][-1]["s"],
                "launches_per_step": a["rows"][-1]["launches"],
                "peak_memory_bytes": [rep["12a"]["peak_memory_bytes"] for rep in reps],
                "single_peak_memory_bytes": sa["peak_memory_bytes"],
                "single_bytes": sa["bytes"], "rank_bytes": [rep["12a"]["bytes"] for rep in reps],
                "collectives_per_step": coll, "collective_s_share": coll_s / step_s,
                "gather_bytes_over_f32": coll.get("all_gather_bytes", 0) / max(f32_gather, 1),
                "init_s": a["init_s"],
                "max_sumsq_rel_diff": [max(abs(row["sumsq"][p] / v - 1)
                                           for p, v in srow["sumsq"].items())
                                       for row, srow in zip(a["rows"], sa["rows"])]},
        "12a_cut": {"elementwise": [rep["12a_cut"]["elementwise"] for rep in reps],
                    "losses": r0["12a_cut"]["losses"],
                    "single_losses": single["12a_cut"]["losses"]},
        "12a_f32": {"losses": r0["12a_f32"]["losses"],
                    "single_losses": single["12a_f32"]["losses"]},
        "rel_diff_vs_one_device": {
            name: [{"loss": abs(row["metrics"]["loss"] / srow["metrics"]["loss"] - 1),
                    "grad_norm": abs(row["metrics"]["grad_norm"]
                                     / srow["metrics"]["grad_norm"] - 1),
                    "max_sumsq": max(abs(row["sumsq"][p] / v - 1)
                                     for p, v in srow["sumsq"].items())}
                   for row, srow in zip(r0[name]["rows"], single[name]["rows"])]
            for name, _, _ in TRAIN_MESH_RUNS},
        "order_noise": {name: single[name]["order_noise"] for name, _, _ in TRAIN_MESH_RUNS},
        "12b": {k: r0["12b"][k] for k in ("save_s", "restore_s", "loss_after_restore")},
    }
    for rep, rb in zip(reps, report["12a"]["rank_bytes"]):
        ratio = {k: v / sa["bytes"][k] for k, v in rb.items()}
        report["12a"].setdefault("bytes_ratio", []).append(ratio)
    # -- 12c. launch.train on 4 ranks ------------------------------------------
    t0 = time.perf_counter()
    res = mesh_mod.run_ranks([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                              LM_ARCH, "--smoke", "--quant", "tnn", "--steps",
                              str(TRAIN_LAUNCH_STEPS), "--lr", "3e-3"], TRAIN_MESH_WORLD,
                             timeout_s=TRAIN_MESH_TIMEOUT_S, env=env, cwd=str(ROOT),
                             log_dir=str(out_dir / "logs_launch"))
    if any(r["returncode"] != 0 for r in res):
        raise AssertionError("12c: launch.train failed on a rank\n" + mesh_mod.rank_logs(res))
    text = open(res[0]["log"]).read()
    found = re.findall(r"\[launch\.train\] done at step (\d+); loss ([\d.]+) -> ([\d.]+) on "
                       r"(.*)", text)
    if not found or int(found[-1][0]) != TRAIN_LAUNCH_STEPS \
            or not float(found[-1][2]) < float(found[-1][1]):
        raise AssertionError(f"12c: the loss did not fall on the mesh\n{text[-3000:]}")
    report["12c"] = {"steps": int(found[-1][0]), "first_loss": float(found[-1][1]),
                     "last_loss": float(found[-1][2]), "where": found[-1][3],
                     "s": time.perf_counter() - t0}
    report["phase_s"] = time.perf_counter() - t_phase
    launches = {key: {"12a": a["rows"][-1]["launches"].get(key, 0),
                      "12a_cut": r0["12a_cut"]["rows"][-1]["launches"].get(key, 0)}}
    return report, launches


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


def mesh_only(torch) -> int:
    """``--mesh``: phases 1, 2 and 11."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, _ = device_and_build(torch, _build)
    from repro_torch import obs
    from repro_torch.tune import cache as plan_cache

    plan_cache.set_cache_path(str(ROOT / "build" / "chip_smoke" / "tune_mesh.json"))
    obs.set_enabled(True)
    report, launches = phase11(torch, dev)
    log("[mesh] " + json.dumps(report))
    log("[mesh] launches by kernel and sub-phase (rank 0): " + json.dumps(launches))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


def train_mesh_only(torch) -> int:
    """``--train-mesh``: phases 1, 2 and 12."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, _ = device_and_build(torch, _build)
    report, launches = phase12(torch, dev)
    log("[train mesh] " + json.dumps(report))
    log("[train mesh] launches per rank per step (rank 0): " + json.dumps(launches))
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
    parser.add_argument("--mesh", action="store_true",
                        help="run only the device and build phases and phase 11")
    parser.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--train-mesh", action="store_true",
                        help="run only the device and build phases and phase 12")
    parser.add_argument("--train-mesh-rank", default=None, help=argparse.SUPPRESS)
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
    if args.mesh_rank:
        return mesh_rank(torch, args.mesh_rank)
    if args.mesh:
        return mesh_only(torch)
    if args.train_mesh_rank:
        return train_mesh_rank(torch, args.train_mesh_rank)
    if args.train_mesh:
        return train_mesh_only(torch)
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
    # every qmm consults the autotuner's plan cache: keep it in the
    # checkout's build directory, empty at the start of each run
    from repro_torch import obs
    from repro_torch.tune import cache as plan_cache

    main_plans = ROOT / "build" / "chip_smoke" / "tune_main.json"
    main_plans.unlink(missing_ok=True)
    plan_cache.set_cache_path(str(main_plans))
    obs.set_enabled(True)          # phase 9 reads the engines' own metrics

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
    # -- 9. serving: the Engine, its tuner, faults, the launcher (before any
    # profiler session) ----------------------------------------------------
    serve_report, serve_launches = phase9(torch, dev, lm_state, card)
    for k_, v_ in serve_launches.items():
        lm_launches[k_] = lm_launches.get(k_, 0) + v_
    log(card)
    # -- 10. training: Trainer, the optimizer variants, resume, launch.train
    # (before any profiler session) -------------------------------------------
    train_report, train_launches = phase10(torch, dev)
    log(card)
    # -- 11. the serving mesh: ranks sharing the card (before any profiler
    # session) ---------------------------------------------------------------
    mesh_report, mesh_launches = phase11(torch, dev)
    log("[mesh] " + json.dumps(mesh_report))
    log(card)
    # -- 12. the training mesh: ranks sharing the card (before any profiler
    # session) ---------------------------------------------------------------
    tmesh_report, tmesh_launches = phase12(torch, dev)
    log("[train mesh] " + json.dumps(tmesh_report))
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
    # -- 10f. one training step under torch.profiler -------------------------
    t0 = time.perf_counter()
    train_report["10f"] = train_profile(torch, dev, train_report["10a"]["mean_step_ms"])
    train_report["10f"]["s"] = time.perf_counter() - t0
    log("[train 10f] " + json.dumps(train_report["10f"]))
    for k in kernels:
        if k["name"] in lm_launches:
            k["launches_lm_path"] = lm_launches[k["name"]]
        per = {p: n[k["name"]] for p, n in train_launches.items() if k["name"] in n}
        if per:     # each sub-phase at its own size: 10a and 10c full width, 10e smoke
            k["launches_train_path"] = per
        if k["name"] in mesh_launches:     # rank 0's, each sub-phase's own run
            k["launches_mesh_path"] = mesh_launches[k["name"]]
        if k["name"] in tmesh_launches:    # rank 0's, per step of each sub-phase
            k["launches_train_mesh_path"] = tmesh_launches[k["name"]]
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
    s9a, s9b = serve_report["9a"], serve_report["9b"]
    rates = {name: ", ".join("%.1f" % r["generated_tokens_per_s"] for r in s9a[name])
             for name in ("tuned", "untuned")}
    log(f"[serve] {LM_ARCH} Engine, {SERVE_REQUESTS} requests of "
        f"{SERVE_PROMPT[0]}-{SERVE_PROMPT[1]} prompt tokens, {SERVE_NEW_TOKENS} new each, "
        f"{SERVE_SLOTS} slots: bucket engine tokens/s tuned {rates['tuned']} (untuned "
        f"{rates['untuned']}), TTFT "
        f"p50 {s9a['tuned'][0]['ttft_s']['p50']:.3f} s, inter-token p50 "
        f"{s9a['tuned'][0]['inter_token_s']['p50'] * 1e3:.1f} ms, {s9a['forwards']} forwards "
        f"x {tnn_gemms_per_forward(lm_state[1])} fused TNN launches, sweep "
        f"{s9a['sweep_s']:.1f} s; chunked tnn2 "
        f"{s9b['metrics']['generated_tokens_per_s']:.1f} tokens/s, cache bytes bf16 / tnn2 "
        f"{s9b['cache_bytes']['ratio']:.2f}; every run == plain, tuned == untuned; an "
        f"injected kernel failure raised and was quarantined; launch.serve ran; phase "
        f"{serve_report['phase_s']:.1f} s")
    t10 = train_report["10a"]
    log(f"[train] {LM_ARCH} QAT (tnn, remat) {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"{t10['mean_step_ms']:.1f} ms/step ({t10['tokens_per_s']:.1f} tokens/s; float32 "
        f"bound {t10['step_bound_ms']:.1f} ms; busy share "
        f"{train_report['10f']['device_busy_share']:.3f}), peak memory "
        f"{t10['peak_memory_bytes'] / 2**30:.2f} GiB, {t10['fused_tnn_launches_per_step']} "
        f"fused TNN launches per step; moment bytes f32 / int8 "
        f"{train_report['10c']['moment_ratio_f32_over_int8']:.2f}; kernels == plain, resume "
        f"== uninterrupted; launch.train loss {train_report['10e']['first5_mean']:.3f} -> "
        f"{train_report['10e']['last5_mean']:.3f}; phase {train_report['phase_s']:.1f} s")
    m11c, m11d = mesh_report["11c"], mesh_report["11d"]
    log(f"[mesh] {MESH_WORLD} ranks on {torch.cuda.device_count()} card(s) over "
        f"{mesh_report['backend']}: "
        f"11a {mesh_report['11a']['checked']} sharded qmm == single-device, 11b "
        f"{mesh_report['11b']['checked']} sharded qconv == single-device; 11c {LM_ARCH} "
        f"(1, 4): {m11c['per_forward']} per rank per forward, tokens == single-device, "
        f"plane bytes x{mesh_report['11c_plane_bytes_ratio']:.3f}, prefill "
        f"{m11c['prefill_tokens_per_s']:.1f} tokens/s, inter-token p50 "
        f"{m11c['inter_token_s'].get('p50', 0) * 1e3:.1f} ms (single device "
        f"{mesh_report['single_device']['inter_token_s'].get('p50', 0) * 1e3:.1f} ms); 11d "
        f"(2, 2): {m11d['per_forward_before']} per forward, rank 3 flagged, rebuilt on "
        f"(1, 2) in {m11d['rebuild_s']:.1f} s, tokens == single-device; phase "
        f"{mesh_report['phase_s']:.1f} s")
    t12 = tmesh_report["12a"]
    log(f"[train mesh] {TRAIN_MESH_WORLD} ranks on {torch.cuda.device_count()} card(s) over "
        f"{tmesh_report['backend']}, mesh {TRAIN_MESH_SHAPE} TRAIN_RULES: 12a {LM_ARCH} QAT "
        f"(tnn, remat, int8 moments, EF, bf16 wire) {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"{t12['step_s'][-1] * 1e3:.1f} ms/step ({t12['tokens_per_s']:.1f} tokens/s; one "
        f"device {t12['single_step_s'][-1] * 1e3:.1f} ms), losses {t12['losses']} (one device "
        f"{t12['single_losses']}), {t12['launches_per_step']} per rank per step, collectives "
        f"{t12['collective_s_share']:.2f} of a step, gathers at "
        f"{t12['gather_bytes_over_f32']:.3f} of float32 bytes, master/moment/EF bytes per rank "
        f"{t12['bytes_ratio'][0]} of one device; first-forward planes == one device; 12b "
        f"save {tmesh_report['12b']['save_s']:.1f} s, restore onto (4, 1) "
        f"{tmesh_report['12b']['restore_s']:.1f} s, == saved, resumed == uninterrupted; 12c "
        f"launch.train loss {tmesh_report['12c']['first_loss']} -> "
        f"{tmesh_report['12c']['last_loss']}; phase {tmesh_report['phase_s']:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
