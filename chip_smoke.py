#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the kernels from this checkout, holds every kernel
against its plain PyTorch version, drives the main path, times it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times [--src DIR]
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --train-mesh [--train-mesh-fault]
    python3 chip_smoke.py --dryrun

The second form runs phases 1, 2 and the GeMM rows of phase 6 only
(popcount, dense, u8 and u4), for the ``repro_torch`` package under
``DIR`` (default this checkout's ``src``): the way to time another
checkout's GeMM kernels, e.g. the parent commit's, on the same card.
The third runs phases 1, 2 and 11 only, the fourth phases 1, 2 and 12
(with ``--train-mesh-fault`` its ranks run the faulty step the bounds of
``TRAIN_MESH_BOUNDS`` must reject: norm scales that sum their gradients
over the batch axes only, and under int8 / int4 a weight's grid
calibrated on the rank's chunk; the phase prints the readings and fails),
the fifth phases 1, 2, 7a, 10a and 13 (13b and 13c then hold the
placeholder meshes to the formulas, not to 11c and 12a).
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
   run through the plain versions, layer by layer (the statistics
   kernel once per conv too); each low-bit layer
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
   both kernels' device time; a statistics row, ``conv_stats_<mode>``,
   holds ``act_stats_kernel`` at each main-path conv input and at
   VGG-Small's five conv inputs at batch 1,024, ``VGG_SMALL_INPUTS``,
   against its plain version on the same tensor to ``STAT_RTOL`` and
   against a float64 evaluation of its weighted formulas to ``F64_RTOL``)
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
    12a's configurations on one device (the references), then
    ``TRAIN_MESH_WORLD`` ranks of this script (``--train-mesh-rank``) on a
    ``TRAIN_MESH_SHAPE`` ("data", "model") mesh, sharing the card over
    gloo (one card each over NCCL where the machine has them); every rank
    must exit 0:
    12a. a ``Trainer`` of QAT under ``tnn`` on TinyLlama-1.1B at its
        published width, ``TRAIN_MESH_LAYERS`` of its 22 layers (remat,
        AdamW with int8 moments at lr
        ``TRAIN_MESH_LR``, EF compression, bf16 compute copies gathered
        over "data" and bf16 cotangents reduce-scattered) under
        ``TRAIN_RULES``: heads, FFN, vocab and the sequence split over
        "model" (``train_layout()``, tp 2), ``TRAIN_MESH_STEPS`` steps of
        ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, each rank the rows of its
        "data" coordinate; launch and collective counters zeroed just
        before each step and read just after: exactly 2 x 5 x 11 fused and
        2 x 2 x 11 int32 TNN GeMM launches per rank per step (the
        column-parallel wq/wk/wv/gate/up and the row-parallel wo/down, the
        remat recompute doubling the forward's) and nothing else; the
        collectives ``train_mesh_collectives`` predicts, exactly; the first
        forward's column-parallel planes equal to one device's n chunk at
        the rank's "model" coordinate (a checksum of every projection's,
        ``torch.equal`` for the first layer's five); row 1 and row 4a
        ``torch.equal`` to their plain versions at the rank's own
        operands; the first layer's row-parallel int32 counts, reduced over
        "model", equal to one device's core on the whole matrices packed
        with the rank's statistics; the loss, ``grad_norm``, each
        parameter leaf's sum of squares and each gradient's after each
        step within ``TRAIN_MESH_BOUNDS`` of one device's; ms per step and
        tokens/s of the ranks time-sharing the card (not a scaling figure)
        beside one device's, peak memory per rank, master / moment / EF
        bytes per rank against one device's, collectives per step with
        their bytes and host seconds; then the same at ``LM_CUT_LAYERS``
        layers under ``tnn`` ("12a_cut", every master elementwise against
        one device's) and under ``f32`` ("12a_f32"), and "12d": the
        ``LM_CUT_LAYERS``-layer ``tnn`` run under ``TRAIN_RULES_FSDP``
        (every leaf gathered whole, 2 x 7 x 2 fused launches, planes equal
        to one device's whole);
    12e / 12f. as 12a, Qwen2-MoE-A2.7B at its published widths (60 experts
        top 4 of d_ff 1408, a shared expert of 5632, vocab 151936) cut to
        ``MOE_MESH_LAYERS`` layers, and Mamba2-1.3B at its published width
        and depth (48 layers, 64 SSD heads, 1 group, 2 chunks of 256): the
        experts' FFN and the SSM heads split over "model"; per rank per
        step the fused and int32 TNN launches ``train_mesh_launches``
        predicts from the shapes (column-parallel wq/wk/wv, every expert's
        and the shared expert's gate and up, in_proj on the rank's heads'
        columns; row-parallel wo, every down, out_proj; 2 x 125 x 2 fused
        and 2 x 62 x 2 int32 at 12e, 2 x 48 of each at 12f) and the
        collectives ``train_mesh_collectives`` predicts, exactly; the
        first forward's column-parallel planes equal to one device's rows
        (an expert's n chunk, in_proj's heads' columns) and its first
        ``TRAIN_MESH_KEEP`` column-parallel outputs ``torch.equal`` to one
        device's rows of the same projection with the rank's statistics
        passed to both; the readings within ``TRAIN_MESH_BOUNDS``, beside
        one device's with its rows reversed; state bytes per rank against
        one device's;
    12g / 12h. as 12a, TinyLlama-1.1B at its published width under the
        affine policies, ``int8`` at ``TRAIN_MESH_LAYERS`` layers and
        ``int4`` at ``LM_CUT_LAYERS`` (f32 moments, no EF): every
        projection's per-tensor grid over the whole weight (a max over
        "model"), the column-parallel ones on the rank's n slice and the
        row-parallel ones' eq. (3) int32 cores reduce-scattered; per rank
        per step exactly 2 x 7 x 11 ``affine_gemm_u8`` (2 x 7 x 2
        ``affine_gemm_u4``) launches, as on one device, and the
        collectives ``train_mesh_collectives`` predicts; the first
        forward's column-parallel grids equal to one device's columns,
        its first ``TRAIN_MESH_KEEP`` column-parallel outputs equal to
        one device's, rows 8 / 9 ``torch.equal`` to their plain versions
        at the rank's operands (column- and row-parallel), the reduced
        cores equal to one device's core; the readings within
        ``TRAIN_MESH_BOUNDS``, beside one device with its rows reversed;
    12b. at ``LM_CUT_LAYERS`` layers: 12a's state saved on the mesh (whole
        leaves, the reference's format), restored onto (4, 1) equal to the
        saved state re-sharded in memory, and one more step from each
        (under ``torch.use_deterministic_algorithms``) ``torch.equal``;
        save and restore seconds;
    12c. ``python -m repro_torch.launch.train --smoke --quant tnn`` on
        ``TRAIN_MESH_WORLD`` ranks (the (1, 4) host mesh): the loss falls;
13. the dry-run against the card (after 12, before any profiler
    session): TinyLlama-1.1B as published, on ``meta`` tensors through
    ``repro_torch.roofline.op_stats.counting`` (the kernel wrappers record
    their problems, nothing runs):
    13a. 7a's packed ``tnn`` prefill (LM_BATCH x LM_PROMPT) and one decode
        step, 10a's QAT step: the kernel records per key equal to the
        launches 7a and 10a counted on the card (154 per forward, 308 per
        step), the step's float operations equal to ``train_flops``;
    13b. 12a's configuration on a ``PlaceholderMesh`` (2, 2) under
        ``TRAIN_RULES``: 110 fused and 44 int32 records, the collectives
        per rank per step equal to ``train_mesh_collectives`` and to 12a's
        rank 0, key by key (count and bytes per kind and dtype), the float
        operations per rank equal to ``train_step_flops(cfg, 4, 512, tp=2)``
        and a quarter of one device's at that depth within 1%; 11c's serving forward on a
        placeholder (1, 4): 110 fused and 44 int32 records and 44
        all-reduces, equal to 11c's counts; 12e's, 12f's, 12g's and 12h's
        configurations on the placeholder (2, 2): the records
        ``train_mesh_launches`` and the collectives
        ``train_mesh_collectives`` predict, and in the full script the
        launches, collectives (count and bytes) and state bytes of their
        rank 0;
    13c. the train state's bytes per rank equal to 12a's rank 0; the peak of
        live tensor bytes against ``max_memory_allocated`` of 10a and of
        12a's rank 0, each ratio within DRYRUN_PEAK_BAND;
    13d. the roofline (``roofline.analysis``, popcounts at the card's
        maximum SM clock) of 10a's step and 7a's decode step; measured /
        roofline must be at least 1, and the step's measured / float32
        bound is reported;
    13e. ``launch.dryrun.run_cell`` for DRYRUN_CELLS on both placeholder
        DRYRUN_MESHES, the six subprocesses at once: every cell PASS,
        seconds per cell;
    13f. the three examples on the card (``repro_torch.examples``):
        quickstart's exact TBN core, serve_batch ``EXAMPLE_SERVE_ARGS``
        all "ok", train_tinylm ``EXAMPLE_TRAIN_ARGS`` below ln(V); the
        phase within DRYRUN_PHASE_S;
14. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# The card's rates and every bound formula live in repro_torch.roofline.analysis
# (roofline() returns this checkout's copy).
MODES = ("tnn", "tbn", "bnn")
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
# no TPU kernel: the JAX package leaves the conv statistics to XLA
STATS_REPLACES = "src/repro/kernels/conv_fused.py:170 (XLA ops)"
# the statistics kernel against its plain version (float32 tree sums, so a
# few ULPs apart at these sizes) and against float64 sums of the same
# weighted formulas (one float32 rounding of a float64 sum)
STAT_RTOL, F64_RTOL = 2.0 ** -16, 1e-6
GEMM_SOURCE = "src/repro_torch/kernels/csrc/lowbit_gemm.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/lowbit_conv.cu"
DENSE_SOURCE = "src/repro_torch/kernels/csrc/dense_tc.cu"
AFFINE_SOURCE = "src/repro_torch/kernels/csrc/affine_gemm.cu"
DENSE_GEMM_REPLACES = "src/repro/kernels/dense_fused.py:104"
DENSE_CONV_REPLACES = "src/repro/kernels/dense_fused.py:181"
AFFINE_REPLACES = {"u8": "src/repro/kernels/int8_matmul.py:28",
                   "u4": "src/repro/kernels/int4_matmul.py:66"}
TABLE3 = ("f32", "u8", "u4", "tnn", "tbn", "bnn")
# The paper's Cortex-A73 speed-ups (time of the second / time of the
# first), as benchmarks/bench_matmul.py prints them.
PAPER_A73 = {"tnn/f32": 3.63, "tbn/f32": 3.75, "bnn/f32": 10.9, "tnn/u8": 2.51,
             "tnn/u4": 1.44, "bnn/tnn": 2.99}
BATCH, BATCHES = 256, 4
# the inputs of VGG-Small's five TNN convs (3x3 SAME, stride 1) at batch
# 1,024, where act_stats_kernel runs its full grid of blocks: phase 6's
# statistics rows
VGG_SMALL_INPUTS = [(1024, 32, 32, 128), (1024, 16, 16, 128), (1024, 16, 16, 256),
                    (1024, 8, 8, 256), (1024, 8, 8, 512)]
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
                     "tnn_dense": "dense_gemm_tnn", "int8": "affine_gemm_u8",
                     "int4": "affine_gemm_u4"}
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
# TRAIN_MESH_SHAPE ("data", "model") mesh; 12a trains TRAIN_MESH_STEPS
# steps of TRAIN_BATCH x TRAIN_SEQ tokens at lr TRAIN_MESH_LR (warm-up 1)
# under TRAIN_RULES, heads, FFN, vocab and the sequence split over "model"
# (tensor and sequence parallelism), and is held to the same steps on one
# device: TRAIN_MESH_BOUNDS[run][i] bounds the relative differences of
# step i's loss and grad_norm and, after the first step, of each parameter
# leaf's sum of squares and of the sum of squares of each leaf's gradient
# (after EF, as AdamW takes it).  The tnn runs' bounds are wide because the
# card's float products round differently at the rank's shapes than at one
# device's (cuBLAS picks its kernel by shape), the ranks round a
# column-parallel input's cotangent once after their float32 sum where one
# device rounds each projection's and then their sum, and a ternary
# threshold turns a last-bit difference of an activation into a different
# ternary value; at 22 layers the differences compound.  Each one-device
# reference runs a second time with the rows of its batches reversed, and
# its differences from the first print beside the mesh's: the floor that
# the device's own float sums set (PERF.md gives both).  "12a_f32" runs the
# same mesh at LM_CUT_LAYERS layers with float32 projections, no
# threshold, and holds it tighter: its remaining differences are the float
# rounding and the bf16 wire.  At LM_CUT_LAYERS layers every tnn master
# after the first step is within 2 lr of one device's (a flipped gradient
# sign moves it by that much), and at most TRAIN_MESH_MOVED_MAX of them by
# more than 1e-3 lr.  "12d" runs LM_CUT_LAYERS layers under
# TRAIN_RULES_FSDP ("model" splits the batch; every leaf gathered whole).
# Each gradients' sum-of-squares bound of a TRAIN_RULES run lies between
# the readings of a sound step and of one whose norm scales sum their
# gradients over the batch axes only (``--train-mesh-fault``); that fault
# moves neither the loss nor grad_norm (Adam's first update is lr *
# sign(g)), whose bounds sit at about twice a sound step's readings
# (PERF.md gives both, and the one-device floor, for every bound).
# The second update is not bounded elementwise: with int8 moments and EF
# (the reference's arithmetic, which the JAX package shows too) an element
# whose EF gradient rounds to 0 while its int8 v rounded to 0 and its m did
# not takes a step of m / eps.
# "12e" and "12f" train Qwen2-MoE-A2.7B at its published widths (60
# experts top 4, d_ff 1408, shared 5632, vocab 151936), its depth cut to
# MOE_MESH_LAYERS (one device holds the reference: ~0.57 B parameters a
# layer and 0.62 B of embedding and head at ~27 bytes each, PERF.md §4),
# and Mamba2-1.3B at its published width and depth (48 layers, 64 heads,
# d_inner 4096, state 128, 1 group; 2 SSD chunks of 256), as 12a: the
# experts' FFN and the SSM heads split over "model".
# 12a runs TRAIN_MESH_LAYERS of TinyLlama's 22 layers and no rows-reversed
# floor (TRAIN_MESH_FLOORS; PERF.md keeps the 22-layer floor): the cuts
# that keep the whole script near 900 s with 12e and 12f beside it.
# "12g" and "12h" train TinyLlama-1.1B at its published width under the
# affine policies (AFFINE_POLICIES: f32 moments, no EF), int8 at
# TRAIN_MESH_LAYERS layers and int4 at LM_CUT_LAYERS: every projection's
# per-tensor grid spans its whole weight, so a column-parallel one's
# takes a max over "model" too, and the row-parallel eq. (3) cores are
# summed over "model" as int32.
TRAIN_MESH_WORLD, TRAIN_MESH_SHAPE, TRAIN_MESH_STEPS = 4, (2, 2), 2
TRAIN_MESH_LR, TRAIN_MESH_TIMEOUT_S, TRAIN_MESH_MOVED_MAX = 3e-4, 900, 0.05
TRAIN_MESH_LAYERS, MOE_MESH_LAYERS = 11, 2
AFFINE_POLICIES = ("int8", "int4")
# (name, arch, layers, policy, ruleset, the one-device run it is held to)
TRAIN_MESH_RUNS = (("12a", LM_ARCH, TRAIN_MESH_LAYERS, "tnn", "train", "12a"),
                   ("12a_cut", LM_ARCH, LM_CUT_LAYERS, "tnn", "train", "12a_cut"),
                   ("12a_f32", LM_ARCH, LM_CUT_LAYERS, "f32", "train", "12a_f32"),
                   ("12d", LM_ARCH, LM_CUT_LAYERS, "tnn", "train_fsdp", "12a_cut"),
                   ("12e", MOE_ARCH, MOE_MESH_LAYERS, "tnn", "train", "12e"),
                   ("12f", SSM_ARCH, None, "tnn", "train", "12f"),
                   ("12g", LM_ARCH, TRAIN_MESH_LAYERS, "int8", "train", "12g"),
                   ("12h", LM_ARCH, LM_CUT_LAYERS, "int4", "train", "12h"))
TRAIN_MESH_BOUNDS = {
    "12a": ({"loss": 1e-2, "grad_norm": 7e-2, "sumsq": 1e-3, "grad_sumsq": 0.3},
            {"loss": 5e-3, "grad_norm": 0.15, "sumsq": None, "grad_sumsq": 0.38}),
    "12a_cut": ({"loss": 1e-3, "grad_norm": 1e-3, "sumsq": 1e-3, "grad_sumsq": 0.1},
                {"loss": 2e-2, "grad_norm": 1e-1, "sumsq": None, "grad_sumsq": 0.3}),
    "12a_f32": ({"loss": 1e-5, "grad_norm": 1e-3, "sumsq": 1e-4, "grad_sumsq": 1e-2},
                {"loss": 1e-4, "grad_norm": 1e-2, "sumsq": None, "grad_sumsq": 5e-2}),
    "12d": ({"loss": 1e-3, "grad_norm": 1e-3, "sumsq": 1e-3, "grad_sumsq": 0.1},
            {"loss": 2e-2, "grad_norm": 1e-1, "sumsq": None, "grad_sumsq": 0.3}),
    # 12e, 12f: loss, grad_norm and sums of squares ~2x the larger of a
    # sound step's reading and the rows-reversed floor's, the gradients' sums
    # (and 12f's grad_norm) the geometric mean of sound and faulty (PERF.md)
    "12e": ({"loss": 6e-3, "grad_norm": 1.5e-2, "sumsq": 2e-3, "grad_sumsq": 0.26},
            {"loss": 2e-3, "grad_norm": 2e-2, "sumsq": None, "grad_sumsq": 0.23}),
    "12f": ({"loss": 2e-3, "grad_norm": 1e-2, "sumsq": 8e-2, "grad_sumsq": 0.43},
            {"loss": 6e-3, "grad_norm": 5e-3, "sumsq": None, "grad_sumsq": 0.38}),
    # 12g, 12h: as 12e's and 12f's were set; the first step's loss is one
    # device's to the bit (every integer core and statistic exact)
    "12g": ({"loss": 1e-5, "grad_norm": 1e-4, "sumsq": 1.5e-6, "grad_sumsq": 4e-3},
            {"loss": 2.5e-4, "grad_norm": 2.5e-3, "sumsq": None, "grad_sumsq": 1.7e-2}),
    "12h": ({"loss": 1e-5, "grad_norm": 2e-5, "sumsq": 4e-6, "grad_sumsq": 6e-3},
            {"loss": 3.5e-3, "grad_norm": 3e-3, "sumsq": None, "grad_sumsq": 7e-2}),
}
# the one-device references run a second time with their rows reversed
TRAIN_MESH_FLOORS = ("12a_cut", "12a_f32", "12e", "12f", "12g", "12h")
# the first forward's projections whose planes and operands each run keeps
# (the first layer's first column-parallel ones on a tensor-parallel rank;
# those and the first ones of its layer on one device)
TRAIN_MESH_KEEP = 7
# Phase 13, the dry-run against the card: TinyLlama-1.1B's production cells
# DRYRUN_CELLS on the placeholder DRYRUN_MESHES (one subprocess each, at most
# DRYRUN_CELL_TIMEOUT_S); a peak estimate within DRYRUN_PEAK_BAND of the
# card's; the phase within DRYRUN_PHASE_S; the examples with short arguments.
DRYRUN_CELLS, DRYRUN_MESHES = ("train_4k", "prefill_32k", "decode_32k"), ("pod", "multipod")
DRYRUN_CELL_TIMEOUT_S, DRYRUN_PEAK_BAND, DRYRUN_PHASE_S = 300, (0.5, 2.0), 240
EXAMPLE_SERVE_ARGS = ["--quant", "tnn", "--packed", "--requests", "6", "--slots", "2",
                      "--new-tokens", "8"]
EXAMPLE_TRAIN_ARGS = ["--quant", "tnn", "--steps", "60", "--d-model", "128", "--layers", "2",
                      "--vocab", "512", "--batch", "8", "--seq", "64", "--lr", "3e-3"]


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
    from ``torch.profiler``: [(kernel name, device ms, calls), ...].  The
    program's spans (``repro_torch.*``, ``obs.annotate``), which the
    profiler lists among the device rows over the kernels they hold, are
    left out, so that no kernel counts twice."""
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
            and e.self_device_time_total > 0 and not e.key.startswith("repro_torch.")]
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


_ROOFLINE = []


def roofline():
    """This checkout's ``repro_torch.roofline.analysis``: the imported one,
    or, when the ``repro_torch`` on ``sys.path`` is another checkout's
    (``--gemm-times --src DIR``), this checkout's file loaded on its own
    (it imports nothing at load time), so that checkout's kernels are
    bounded with this checkout's formulas."""
    if not _ROOFLINE:
        import repro_torch

        here = ROOT / "src" / "repro_torch"
        if pathlib.Path(repro_torch.__file__).resolve().parent == here.resolve():
            from repro_torch.roofline import analysis as mod
        else:
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "chip_smoke_roofline", here / "roofline" / "analysis.py")
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod       # dataclasses resolve their module
            spec.loader.exec_module(mod)
        _ROOFLINE.append(mod)
    return _ROOFLINE[0]


def work_bound(work, max_sm_mhz: float = None):
    """(ms, "operations" | "bytes"): the least time for a
    ``roofline.analysis.Work`` on the card (popcounts at the maximum SM
    clock ``max_sm_mhz``, else the data sheet's)."""
    A = roofline()
    hw = A.HW() if max_sm_mhz is None else A.HW(sm_clock_hz=max_sm_mhz * 1e6)
    return work.bound(hw)


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


def stats_f64(x, mode: str, kh: int, kw: int, stride: int, padding: str,
              thr=None) -> dict:
    """``conv_act_stats``' weighted formulas in float64 on ``x``'s device:
    the padded input times the multiplicity map, thr = 0.7 mean |A|; the
    masked sums take ``thr`` where given (the kernel's own, so that only
    the sums are compared)."""
    from repro_torch.kernels import conv_fused

    xp, (oh, ow) = conv_fused.conv_spatial_pad(x.double(), kh, kw, stride, padding)
    b, hp, wp, c = xp.shape
    m = conv_fused._patch_multiplicity(hp, wp, kh, kw, stride, oh, ow, x.device)
    m = m.double()[None, :, :, None]
    a = xp.abs()
    mean = (a * m).sum().item() / (b * oh * ow * kh * kw * c)
    if mode == "bnn":
        return {"scale": mean}
    keep = a > (0.7 * mean if thr is None else thr)
    return {"thr": 0.7 * mean,
            "scale": (a * m * keep).sum().item() / max((m * keep).sum().item(), 1.0)}


def stats_rows(dev, gen, main_inputs, launches, launches2, check):
    """Phase 6's statistics rows, one a mode: ``act_stats_kernel``
    (``conv_fused.conv_act_stats`` on CUDA operands, 3x3 SAME or the
    layer's geometry) at the mode's main-path conv inputs
    (``main_inputs[mode]``: [(x, kh, kw, stride), ...]) and at
    ``VGG_SMALL_INPUTS`` (ReLU'd N(0, 1), 3x3 SAME).  Each call is held
    against the plain version on the same tensor (``STAT_RTOL``; the
    largest |kernel - plain| goes to ``check.max_err``) and against
    :func:`stats_f64` (``F64_RTOL``), and must give the same bits twice;
    then ms (CUDA events), the kernel's device ms (torch.profiler), the
    plain version's ms and the bound (``conv_stats_work`` bytes), each
    summed over the main path's inputs and, under ``vgg_small_b1024``,
    over VGG-Small's."""
    import torch
    from repro_torch.kernels import conv_fused
    from repro_torch.kernels.modes import QuantMode

    def acc():
        return {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "shapes_bhwc": []}

    sums = {m: {"main": acc(), "vgg": acc()} for m in MODES}
    f64_err = {m: 0.0 for m in MODES}

    def measure(mode, x, kh, kw, stride, where):
        name, qm = f"conv_stats_{mode}", QuantMode(mode)
        what = f"{name} at {tuple(x.shape)} k{kh} s{stride}"

        def call():
            return conv_fused.conv_act_stats(x, qm, kh, kw, stride, "SAME")

        def plain():
            return conv_fused.conv_act_stats_torch(x, qm, kh, kw, stride, "SAME")
        got, again, want = call(), call(), plain()
        ref = stats_f64(x, mode, kh, kw, stride, "SAME",
                        None if mode == "bnn" else got["thr"].item())
        if sorted(got) != sorted(want):
            raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
        for key, v in got.items():
            if not torch.equal(v, again[key]):
                raise AssertionError(f"{what}: {key} differs between two calls")
            g, p, f = v.item(), want[key].item(), ref[key]
            check.max_err[name] = max(check.max_err.get(name, 0.0), abs(g - p))
            f64_err[mode] = max(f64_err[mode], abs(g - f) / abs(f) if f else abs(g))
            if not (abs(g - p) <= STAT_RTOL * abs(p) and abs(g - f) <= F64_RTOL * abs(f)):
                raise AssertionError(f"{what}: {key} {g!r}, plain {p!r}, float64 {f!r}")
        s = sums[mode][where]
        s["ms"] += cuda_ms(call, reps=20)
        s["device_ms"] += kernel_device_ms(call, "act_stats_kernel", reps=5) or 0.0
        s["plain_ms"] += cuda_ms(plain, reps=5, warmup=1)
        s["bound_ms"] += work_bound(roofline().conv_stats_work(mode, *x.shape))[0]
        s["shapes_bhwc"].append(list(x.shape))

    for mode in MODES:
        for x, kh, kw, stride in main_inputs[mode]:
            measure(mode, x, kh, kw, stride, "main")
    for shape in VGG_SMALL_INPUTS:
        x = torch.relu(torch.randn(shape, generator=gen, device=dev))
        for mode in MODES:
            measure(mode, x, 3, 3, 1, "vgg")
        del x
    rows = []
    for mode in MODES:
        name, main, vgg = f"conv_stats_{mode}", sums[mode]["main"], sums[mode]["vgg"]
        vgg["device_ms"] = vgg["device_ms"] or None
        rows.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE,
            "replaces": STATS_REPLACES, "launches": launches.get(name, 0),
            "launches_dense_path": launches2.get(name, 0),
            "max_abs_err": check.max_err[name], "max_rel_err_f64": f64_err[mode],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "device_ms": main["device_ms"] or None,
            "shapes_bhwc": main["shapes_bhwc"], "vgg_small_b1024": vgg})
    return rows


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
                 "lib": lambda ad=ad, bd=bd: torch.matmul(ad, bd), "mnk": [m, n, k]}
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
                A = roofline()
                b_ms, b_by = work_bound(
                    A.dense_gemm_work(mode, m, n, kw, c["k"]) if dense else
                    A.gemm_work(mode, m, n, kw, c["k"], fused), max_sm_mhz)
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
            b_ms, b_by = work_bound(roofline().affine_gemm_work(m, n, k, tag == "u4"))
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
    rows (``m_expert`` rows per MoE expert): ``roofline.analysis``'s."""
    return roofline().proj_shapes(cfg, m, m_expert)


def tnn_gemms_per_forward(cfg) -> int:
    """Fused TNN GeMM launches of one forward of a model packed under tnn:
    one per projection, every MoE expert included (each runs on its
    capacity rows)."""
    return len(proj_shapes(cfg, 1, 1))


def kv_bytes_per_token(cfg, kv: str) -> int:
    """Cache bytes one token occupies in one attention layer
    (``roofline.analysis``'s)."""
    return roofline().kv_bytes_per_token(cfg, kv)


def lm_bounds(cfg, batch, prompt, steps, packed_bytes, kv="bf16"):
    """Least times of an LM run, from shapes (``roofline.analysis.lm_bounds``:
    a decode step's bytes at 3.35 TB/s, the prefill's popcounts at 16 per
    clock per SM, 132 SMs, 1980 MHz).  Returns (decode ms, prefill GeMM
    ms)."""
    return roofline().lm_bounds(cfg, batch, prompt, steps, packed_bytes, kv)


def lm_phase(torch, dev, only_7a: bool = False):
    """Phase 7a-7c (see the module docstring), or with ``only_7a`` phase 7a
    alone (``--dryrun``); nothing here runs under torch.profiler.  Returns
    (the report, {kernel: launches on the LM path}, what phase 7d profiles,
    None with ``only_7a``)."""
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
    if only_7a:
        del master, packed
        torch.cuda.empty_cache()
        return report, lm_launches, None

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
    shapes (``roofline.analysis.train_step_flops``)."""
    return roofline().train_step_flops(cfg, batch, seq)


def phase10(torch, dev, only_10a: bool = False):
    """Phase 10a-10e (see the module docstring), or with ``only_10a``
    phase 10a alone (``--dryrun``); nothing here runs under torch.profiler.
    Returns (the report, {sub-phase: {kernel: launches}} for 10a and 10c
    at full width and 10e at the smoke width)."""
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
        "step_bound_ms": roofline().Work({"f32": flops}).compute_s() * 1e3}
    log("[train 10a] " + json.dumps(report["10a"]))
    del state, tr, res
    torch.cuda.empty_cache()
    if only_10a:
        return report, launches10

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

def train_mesh_config(num_layers=None, policy="tnn", arch=LM_ARCH):
    """12a's configuration: TinyLlama-1.1B (or ``arch``; its first
    ``num_layers`` layers) under ``policy`` with remat, AdamW with int8
    moments, EF on (under AFFINE_POLICIES float32 moments, no EF), the
    bf16 wire; TRAIN_BATCH x TRAIN_SEQ tokens a step from SyntheticLM
    seed 0.  -> (cfg, tcfg, source)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainStepConfig

    cfg = get_config(arch, quant_policy=policy)
    if num_layers:
        cfg = cfg.with_(num_layers=num_layers)
    affine = policy in AFFINE_POLICIES
    tcfg = TrainStepConfig(optimizer=AdamWConfig(lr=TRAIN_MESH_LR, warmup_steps=1,
                                                 moments_dtype="f32" if affine else "int8"),
                           ef_compression=not affine)
    return cfg, tcfg, SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0)


def plane_digest(torch, t) -> int:
    """A checksum of an int32 plane (int64 sums wrap the same way on any
    order): the first forward's planes are compared by it."""
    w = torch.arange(t.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int((t.reshape(-1).to(torch.int64) * w).sum().item())


def tp_first_forward(cfg):
    """A tensor-parallel rank's column-parallel ``qmm`` calls of one forward
    of ``cfg``, in its order: for each, one device's call index of the same
    projection (one device's order: per layer wq, wk, wv, wo; in_proj,
    out_proj; gate, up, down; an MoE layer's gates, ups and downs expert by
    expert, then the shared expert's) and how the rank's rows of its
    planes are taken from one device's: "chunk" (its n chunk) or "ssm"
    (its heads' in_proj columns, ``models.ssm._tp_dims``).  -> (that list,
    one device's calls per forward)."""
    out, base = [], 0
    for layer in range(cfg.num_layers):
        mixer, ffn = cfg.layer_pattern[layer % cfg.period]
        if mixer in ("A", "AL"):
            out += [(base + i, "chunk") for i in range(3)]
            base += 4
        elif mixer == "M":
            out.append((base, "ssm"))
            base += 2
        if ffn == "D":
            out += [(base, "chunk"), (base + 1, "chunk")]
            base += 3
        elif ffn == "E":
            e = cfg.num_experts
            for i in range(e):
                out += [(base + i, "chunk"), (base + e + i, "chunk")]
            base += 3 * e
            if cfg.shared_expert_d_ff:
                out += [(base, "chunk"), (base + 1, "chunk")]
                base += 3
    return out, base


def tp_rows(torch, cfg, kind, n, j, device="cpu"):
    """The rows (output features) of one device's ``n``-row planes that a
    column-parallel call of ``kind`` (:func:`tp_first_forward`) computes on
    the rank at "model" coordinate ``j``."""
    tp = TRAIN_MESH_SHAPE[1]
    if kind == "ssm":
        from repro_torch.models import ssm

        return ssm._tp_dims(cfg, tp, j, torch.device(device))[1]
    return torch.arange(j * n // tp, (j + 1) * n // tp, device=device)


def tp_row_calls(cfg) -> int:
    """The first layer's row-parallel projections that run
    ``ops._qmm_row_parallel`` (wo, a dense FFN's down, out_proj; an MoE
    layer's downs run ``ops.row_parallel_group``)."""
    mixer, ffn = cfg.layer_pattern[0]
    return int(mixer in ("A", "AL", "M")) + int(ffn == "D")


def kept_planes(qt) -> dict:
    """A packed weight's planes (bit planes (n, kw), or the affine grid
    "q" (k, n)) with its scale, and an affine grid's zero point, on the
    host."""
    out = {**{k: v.cpu() for k, v in qt.payload.items()}, "scale": qt.scale.reshape(-1).cpu()}
    if qt.zero is not None:
        out["zero"] = qt.zero.reshape(-1).cpu()
    return out


def plane_outputs(planes) -> int:
    """The output features of :func:`kept_planes`' weight."""
    return planes["q"].shape[-1] if "q" in planes else planes["scale"].numel()


def planes_at(planes, rows) -> dict:
    """:func:`kept_planes` at the output features ``rows``: a bit plane's
    rows, the affine grid's columns, a per-channel scale's elements; an
    affine grid's per-tensor scale and zero point whole."""
    def take(key, v):
        if key == "q":
            return v.index_select(-1, rows)
        if "q" in planes:
            return v
        return v.index_select(0 if v.ndim == 1 else -2, rows)
    return {k: take(k, v) for k, v in planes.items()}


@contextlib.contextmanager
def record_planes(torch, box, keep, n_forward: int, slices=None):
    """While active, the first ``n_forward`` quantized ``qmm`` calls (the
    first forward's projections that run ``qmm``: every one on one device
    and under ``TRAIN_RULES_FSDP``, the column-parallel ones under tensor
    parallelism): each call's planes' digests (with ``slices``, a function
    of the call's index and output features giving the features of each
    "model" coordinate, also the digests of each selection:
    :func:`planes_at`), and the planes (:func:`kept_planes`) and operands
    (``x``, the packed weight, the activation statistics the call was
    given: a split batch's global ones on the mesh) of the calls whose
    index is in ``keep``, for :func:`operands_vs_plain` and
    :func:`outputs_vs_one_device`."""
    from repro_torch.kernels import ops

    real = ops.qmm
    for key in ("digests", "slice_digests", "planes", "operands"):
        box.setdefault(key, [] if key != "planes" else {})

    def qmm(x, qt, *, backend=None, act_stats=None):
        i = len(box["digests"])
        if not qt.mode.is_float and i < n_forward:
            keys = sorted(qt.payload)
            box["digests"].append([plane_digest(torch, qt.payload[k]) for k in keys])
            if slices is not None:
                n = qt.out_features
                box["slice_digests"].append(
                    [[plane_digest(torch, planes_at(qt.payload, rows)[k]) for k in keys]
                     for rows in slices(i, n)])
            if i in keep:
                box["planes"][i] = kept_planes(qt)
                box["operands"].append((i, x.detach().clone(), qt, act_stats))
        return real(x, qt, backend=backend, act_stats=act_stats)

    ops.qmm = qmm
    try:
        yield box
    finally:
        ops.qmm = real


@contextlib.contextmanager
def record_row_parallel(torch, box, n_keep: int):
    """While active, the first ``n_keep`` row-parallel projections of the
    tensor-parallel forward (``ops._qmm_row_parallel``): this rank's input
    slice, its bf16 weight slice (as float32), the statistics it packed
    with, and, from ``qmm_mesh.k_sharded_matmul``, its activation and
    weight words, tiles and the int32 counts reduced over "model" (its
    sequence shard): for :func:`row_parallel_checks`."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import qmm_mesh

    real_row, real_k = ops._qmm_row_parallel, qmm_mesh.k_sharded_matmul
    box.setdefault("row", [])

    def row(x, w, mode, backend, lead, split, stats):
        keep = len(box["row"]) < n_keep
        if keep:
            box["row"].append({"x": x.detach().clone(), "w": w.detach().clone(),
                               "stats": stats, "lead": lead, "mode": mode})
        return real_row(x, w, mode, backend, lead, split, stats)

    def k_sharded(a_loc, planes, **kw):
        rec = box["row"][-1] if box["row"] and "acc" not in box["row"][-1] else None
        if rec is None:
            return real_k(a_loc, planes, **kw)
        reduce = kw["reduce"]

        def keep_acc(part):
            acc = reduce(part)
            rec["acc"] = acc.clone()
            return acc
        rec.update(a_loc=tuple(a.clone() for a in a_loc), planes=tuple(p.clone() for p in planes),
                   tiles=kw["tiles"])
        return real_k(a_loc, planes, **{**kw, "reduce": keep_acc})

    ops._qmm_row_parallel, qmm_mesh.k_sharded_matmul = row, k_sharded
    try:
        yield box
    finally:
        ops._qmm_row_parallel, qmm_mesh.k_sharded_matmul = real_row, real_k


def row_parallel_checks(torch, records, mesh) -> dict:
    """The int32 core (row 4a; under INT8/INT4 the u8 / u4 kernel's eq. (3)
    core of the rank's k slice, rows 8 / 9) at this rank's own operands of
    the first forward's row-parallel projections, on the card
    ``torch.equal`` to its plain version, and their reduced int32 counts
    against one device's core on the whole matrices: the rank's input
    gathered over "model" (its rows, every feature), the whole weight
    gathered, both packed with the rank's statistics, the plain core, this
    rank's sequence shard of it ``torch.equal`` to the counts.
    Collective: every rank of the mesh calls it."""
    from repro_torch.kernels import ops, registry
    from repro_torch.kernels.modes import QuantMode
    from repro_torch.kernels.qtensor import QTensor
    from repro_torch.parallel import qmm_mesh

    out = {"vs_plain": [], "vs_one_device": [], "shapes": []}
    j, tp = mesh.axis_index("model"), mesh.axis_size("model")
    for rec in records:
        mode = QuantMode(rec["mode"])
        cuda = registry.lookup(mode, "cuda", fused=False)
        plain = registry.lookup(mode, "torch", fused=False)
        part = dict(mode=mode, bit0=0, depth=int(rec["x"].shape[1]))
        with deterministic(torch):
            got = qmm_mesh.k_sharded_partial(rec["a_loc"], rec["planes"], backend="cuda",
                                             spec=cuda, tiles=rec["tiles"], **part)
        want = qmm_mesh.k_sharded_partial(rec["a_loc"], rec["planes"], backend="torch",
                                          spec=plain, tiles=None, **part)
        out["vs_plain"].append(bool(torch.equal(got, want)))
        x = mesh.all_gather_axes(rec["x"].contiguous(), ("model",), 1)
        w = mesh.all_gather_axes(rec["w"].contiguous(), ("model",), 0)
        qt = QTensor.from_dense(w, mode, stats=rec["stats"]["w"])
        xa = ops.quantize_activations(x.to(torch.float32), mode, stats=rec["stats"]["act"])
        core = plain.fn(tuple(xa[k] for k in ops._A_KEYS[mode]), ops._b_planes(qt, mode),
                        qt.k_valid)
        lead = tuple(rec["lead"])
        core = core.reshape(lead + (core.shape[-1],))
        n = lead[-1] // tp
        core = core.narrow(len(lead) - 1, j * n, n).reshape(-1, core.shape[-1])
        out["vs_one_device"].append(bool(torch.equal(core, rec["acc"])))
        out["shapes"].append([int(x.shape[0]), int(w.shape[1]), int(rec["x"].shape[1])])
    return out


def operands_vs_plain(torch, operands) -> dict:
    """Row 1 against its plain version at the main path's own operands:
    each kept projection's ``qmm`` on the card's kernel and with
    ``backend="torch"``, ``torch.equal``, with the (m, n, k) it ran at.
    Called outside the counted window."""
    from repro_torch.kernels import ops

    out = {"shapes": [], "equal": [], "max_abs_err": 0.0}
    with deterministic(torch):
        for _, x, qt, stats in operands:
            got = ops.qmm(x, qt, act_stats=stats)
            want = ops.qmm(x, qt, backend="torch", act_stats=stats)
            out["shapes"].append([int(x.shape[0]), int(qt.shape[1]), int(qt.shape[0])])
            out["equal"].append(bool(torch.equal(got, want)))
            out["max_abs_err"] = max(out["max_abs_err"], float((got - want).abs().max()))
    return out


def outputs_vs_one_device(torch, operands, planes, rows) -> list:
    """The rank's column-parallel outputs of its kept first-forward calls
    against one device's n slice with the statistics passed in: ``qmm`` of
    the rank's ``x`` on its packed slice, and on one device's whole planes
    and scale of the same projection (``planes[i]``) at the rank's
    ``rows[i]``, ``torch.equal``."""
    from repro_torch.kernels import ops

    out = []
    with deterministic(torch):
        for i, x, qt, stats in operands:
            one = {k: v.to(x.device) for k, v in planes[i].items()}
            affine = "zero" in one
            whole = qt.replace(payload={k: v for k, v in one.items() if k not in ("scale", "zero")},
                               scale=one["scale"].reshape(()) if affine else one["scale"],
                               zero=one["zero"].reshape(()) if affine else None,
                               shape=(qt.shape[0], plane_outputs(one)))
            got = ops.qmm(x, qt, act_stats=stats)
            want = ops.qmm(x, whole, act_stats=stats).index_select(1, rows[i].to(x.device))
            out.append(bool(torch.equal(got, want)))
    return out


def sumsq64(torch, t, chunk: int = 1 << 22):
    """The sum of squares of ``t`` in float64, ``chunk`` elements at a time
    (no float64 copy of a whole leaf on the card)."""
    flat = t.reshape(-1)
    return sum(torch.sum(torch.square(flat[i:i + chunk].to(torch.float64)))
               for i in range(0, flat.numel(), chunk))


def leaf_sumsq(torch, state, shardings=None, mesh=None):
    """{path: sum of squares} of every float leaf of ``state["params"]``:
    on a mesh each shard counted once (``sharding.holds_first_copy``; one
    all-reduce)."""
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten_with_paths

    flat = flatten_with_paths(state["params"])
    vals = torch.stack([sumsq64(torch, t) for _, t in flat])
    if mesh is not None:
        sh = dict(flatten_with_paths(shardings["params"]))
        keep = [sharding.holds_first_copy(sh[path].spec, mesh) for path, _ in flat]
        vals = mesh.all_reduce_(vals * torch.tensor(keep, dtype=vals.dtype, device=vals.device))
    return {path: float(v) for (path, _), v in zip(flat, vals.tolist())}


def train_mesh_collectives(cfg, tcfg, sh, mesh, policy) -> dict:
    """The training mesh's collectives per rank per step of a run of
    TRAIN_SEQ tokens under the active rules, predicted from the state's
    shardings ``sh`` (``roofline.analysis.train_mesh_collectives``: the
    leaves' gathers and gradient reductions, the statistics, the tensor-
    and sequence-parallel activations, the loss and the optimizer)."""
    return roofline().train_mesh_collectives(cfg, tcfg, sh, mesh, policy, TRAIN_SEQ)


def train_mesh_launches(cfg, policy: str, tp: bool) -> dict:
    """Launches per rank per step of a training-mesh run (forward and remat
    recompute): under tensor parallelism the column-parallel projections'
    fused TNN GeMMs and every other projection's int32 core (row-parallel:
    wo, down, out_proj, an MoE layer's experts' and shared expert's
    downs), else every projection's fused GeMM (:func:`tp_first_forward`);
    under AFFINE_POLICIES one u8 / u4 kernel a projection either way."""
    fwd = 2 if cfg.remat else 1
    col, calls = tp_first_forward(cfg)
    if policy in AFFINE_POLICIES:
        return {LM_POLICY_KERNELS[policy]: fwd * calls}
    if policy != "tnn":
        return {}
    if tp:
        return {LM_POLICY_KERNELS["tnn"]: fwd * len(col),
                "lowbit_gemm_tnn_i32": fwd * (calls - len(col))}
    return {LM_POLICY_KERNELS["tnn"]: fwd * calls}


def state_bytes(state) -> dict:
    """Bytes of masters, moments and EF buffers."""
    from repro_torch.tree import flatten_with_paths

    out = {}
    for path, t in flatten_with_paths(state):
        group = "moments" if path.startswith("opt/") else path.split("/")[0]
        out[group] = out.get(group, 0) + t.numel() * t.element_size()
    return out


def train_mesh_trainer(torch, dev, cfg, tcfg, source, layout, rows, box, kept, mesh=None,
                       tp=False, record=True):
    """A Trainer of 12a's configuration whose step is instrumented: host
    clock around each synchronized step, the launch and collective
    counters zeroed just before it and read just after, then (outside the
    window) the metrics, every leaf's sum of squares and every leaf's
    gradient's (after EF, as AdamW took it) into ``rows`` and the state
    into ``kept["state"]``; with ``record`` the first step's forward
    recorded into ``box`` (on one device with each plane's two n chunks'
    digests too; with ``tp`` its row-parallel projections as well)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import flatten_with_paths

    tr = Trainer(cfg, layout, tcfg, TrainerConfig(steps=TRAIN_MESH_STEPS, log_every=10**9),
                 source, device=dev, log_fn=log)
    inner = tr.step_fn
    # a rank keeps its first calls (column-parallel ones under tensor
    # parallelism); one device its first and those a tensor-parallel rank
    # keeps, and the digests of each rank's rows of every call
    col, calls = tp_first_forward(cfg)
    kept_calls, n_forward, slices = set(range(TRAIN_MESH_KEEP)), len(col) if tp else calls, None
    if mesh is None:
        kept_calls |= {i for i, _ in col[:TRAIN_MESH_KEEP]}
        kinds = dict(col)

        def slices(i, n):
            return [tp_rows(torch, cfg, kinds.get(i, "chunk"), n, j, dev)
                    for j in range(TRAIN_MESH_SHAPE[1])]

    def step(state, batch):
        grads = {}
        real = adamw.adamw_update

        def update(g, *a, **kw):
            # the gradients as AdamW takes them, summed after the timed window
            grads["tree"] = g
            return real(g, *a, **kw)

        adamw.adamw_update = update
        try:
            torch.cuda.synchronize()
            run_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            mesh_mod.reset_collectives()
            t0 = time.perf_counter()
            if not rows and record:
                with record_planes(torch, box, kept_calls, n_forward, slices), \
                        record_row_parallel(torch, box, tp_row_calls(cfg) if tp else 0):
                    out = inner(state, batch)
            else:
                out = inner(state, batch)
            float(out[1]["loss"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches, coll = _build.launches(), mesh_mod.collectives()
            step_peak = torch.cuda.max_memory_allocated()
            kept["run_peak"] = max(kept.get("run_peak", 0), run_peak, step_peak)
        finally:
            adamw.adamw_update = real
        # this rank's float64 sums of squares of the gradients, outside the window
        g2 = torch.stack([sumsq64(torch, t) for _, t in flatten_with_paths(grads.pop("tree"))])
        kept["state"] = out[0]
        if not rows and kept.get("snapshot"):
            kept["params_after_first"] = {p: t.clone() for p, t in
                                          flatten_with_paths(out[0]["params"])}
        paths = [p for p, _ in flatten_with_paths(out[0]["params"])]
        if mesh is not None:
            sh = dict(flatten_with_paths(tr.shardings["params"]))
            from repro_torch.parallel import sharding

            keep = [sharding.holds_first_copy(sh[p].spec, mesh) for p in paths]
            g2 = mesh.all_reduce_(g2 * torch.tensor(keep, dtype=g2.dtype, device=g2.device))
        rows.append({"s": secs, "peak": step_peak, "launches": launches, "collectives": coll,
                     "metrics": {k: float(v) for k, v in out[1].items()},
                     "sumsq": leaf_sumsq(torch, out[0], tr.shardings, mesh),
                     "grad_sumsq": dict(zip(paths, g2.tolist()))})
        return out

    tr.step_fn = step
    return tr


def fault_norm_sum():
    """``--train-mesh-fault``: leaf plans whose whole leaves (the norm
    scales) sum their gradients over the batch axes only, not over the
    tensor-parallel axis too: the faulty step each TRAIN_RULES bound must
    reject.  Returns the undo."""
    from repro_torch import tree
    from repro_torch.parallel import sharding

    real = sharding.leaf_plans

    def faulty(p_sh, ctx=None, *, sp):
        plans, split = real(p_sh, ctx, sp=sp)
        tp = sharding.tp_axis(ctx)
        return tree.tree_map(lambda pl: pl if pl.split else sharding.LeafPlan(
            pl.gather, tuple(a for a in pl.sum_axes if a != tp)), plans), split

    sharding.leaf_plans = faulty

    def undo():
        sharding.leaf_plans = real
    return undo


def fault_chunk_grid():
    """``--train-mesh-fault`` under AFFINE_POLICIES: each rank calibrates
    an affine weight's grid on its own "model" chunk, with no max over the
    axis: the faulty step 12g's and 12h's bounds must reject.  Returns the
    undo."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.modes import QuantMode

    real = ops.split_weight_stats_many

    def faulty(ws, mode, split):
        mode = QuantMode(mode)
        if mode.value not in AFFINE_POLICIES:
            return real(ws, mode, split)
        return [ops.affine_weight_stats(w, mode) for w in ws]

    ops.split_weight_stats_many = faulty

    def undo():
        ops.split_weight_stats_many = real
    return undo


def train_mesh_rank(torch, out_dir: str, fault: bool = False) -> int:
    """One rank of phase 12 (``--train-mesh-rank``): 12a on (2, 2) at full
    depth and at LM_CUT_LAYERS under TRAIN_RULES, 12d at LM_CUT_LAYERS under
    TRAIN_RULES_FSDP, 12b at LM_CUT_LAYERS; writes ``rank<r>.json`` into
    ``out_dir``.  ``fault``: the norm scales' gradients skip the "model"
    sum (:func:`fault_norm_sum`), and under AFFINE_POLICIES each rank
    calibrates a weight's grid on its chunk instead
    (:func:`fault_chunk_grid`).  Any failure raises."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointConfig, Checkpointer
    from repro_torch.data import DataState, make_pipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import ShardLayout
    from repro_torch.models.common import train_layout
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
    report = {"rank": rank, "backend": mesh.backend, "fault": fault}
    single = torch.load(os.path.join(out_dir, "single.pt"), weights_only=False)
    j = mesh.axis_index("model")

    # -- 12a: full width and depth, then LM_CUT_LAYERS layers; 12d; 12e, 12f ---
    for name, arch, layers, policy, rules, ref_name in TRAIN_MESH_RUNS:
        undo = None
        if fault:
            undo = fault_chunk_grid() if policy in AFFINE_POLICIES else fault_norm_sum()
        cfg, tcfg, source = train_mesh_config(layers, policy, arch)
        # the last run's trainer, its result and its kept final state (but
        # 12a_cut's, kept for 12b in ``cut``), and their cycle
        # (train_mesh_single), are freed before this run's peak is read
        state = tr = res = kept = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what earlier runs leave on the card: 12a_cut's state, kept for 12b
        start_bytes = torch.cuda.memory_allocated()
        rows, box, kept = [], {}, {"snapshot": name == "12a_cut"}
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh, sharding.RULESETS[rules]):
            layout = train_layout()
            tp = sharding.tp_axis() is not None
            tr = train_mesh_trainer(torch, dev, cfg, tcfg, source, layout, rows, box, kept,
                                    mesh, tp=tp)
            expect = train_mesh_collectives(cfg, tcfg, tr.shardings, mesh, policy)
            state, ds = tr.restore_or_init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            nbytes = state_bytes(state)
            res = tr.run(state, ds)
            rp = row_parallel_checks(torch, box["row"], mesh) if tp and box.get("row") \
                else None
        del state
        # the run's peak (init, steps, checks) and the steps' own
        peak = max(kept.get("run_peak", 0), torch.cuda.max_memory_allocated())
        step_peak = max(row["peak"] for row in rows)
        ref = single[ref_name]
        # the one-device digests and planes this rank's first forward matches:
        # the column-parallel projections' rows at its "model" coordinate (the
        # n chunk; an in_proj's heads' columns) under tensor parallelism,
        # every projection whole else
        col, _ = tp_first_forward(cfg)
        outputs = None
        if tp:
            want_d = [ref["slice_digests"][i][j] for i, _ in col] if ref["slice_digests"] else []
            sel = {}
            for i, kind in col[:TRAIN_MESH_KEEP] if ref["planes"] else ():
                sel[i] = tp_rows(torch, cfg, kind, plane_outputs(ref["planes"][i]), j)
            want_p = [planes_at(ref["planes"][i], sel[i]) for i in sel]
            got_p = [box["planes"][k] for k in sorted(box["planes"])]
            # the kept calls' outputs against one device's rows of the same
            # projection, the rank's statistics passed to both
            idx = [i for i, _ in col[:TRAIN_MESH_KEEP]]
            outputs = outputs_vs_one_device(
                torch, [(idx[c], *rest) for c, *rest in box["operands"]],
                ref["planes"], sel) if ref["planes"] else []
        else:
            want_d = ref["digests"]
            want_p = [ref["planes"][i] for i in sorted(ref["planes"]) if i < TRAIN_MESH_KEEP]
            got_p = [box["planes"][i] for i in sorted(box["planes"])]
        report[name] = {
            "rows": rows, "losses": res.losses, "init_s": init_s, "peak_memory_bytes": peak,
            "step_peak_memory_bytes": step_peak, "start_allocated_bytes": start_bytes,
            "collectives_expected": expect, "launches_expected": train_mesh_launches(
                cfg, policy, tp), "tp": tp,
            "vs_plain": operands_vs_plain(torch, box["operands"]),
            "outputs_vs_one_device": outputs,
            "row_parallel": rp, "bytes": nbytes, "coords": mesh.coords,
            "n_digests": len(box["digests"]), "n_digests_expected": len(want_d),
            "first_differing_digest": next((k for k, (x, y) in enumerate(
                zip(box["digests"], want_d)) if x != y), None),
            "digests_equal": box["digests"] == want_d,
            "planes_equal": len(got_p) == len(want_p) and all(
                torch.equal(a[k], b[k]) for a, b in zip(got_p, want_p) for k in b)}
        del box
        if name == "12a_cut":
            cut = kept, tr.shardings, cfg, tcfg, source
        log(f"[train mesh {name}] rank {rank}: steps {[round(r['s'], 3) for r in rows]} s, "
            f"losses {res.losses}, peak {peak / 2**30:.2f} GiB (steps "
            f"{step_peak / 2**30:.2f} GiB)")
        if undo is not None:
            undo()
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


def reversed_rows(source):
    """``source`` (a SyntheticLM) whose every batch holds its rows in
    reverse order."""
    import dataclasses

    import numpy as np

    class Reversed(type(source)):
        def batch_at(self, state, rows=None):
            return {k: np.ascontiguousarray(v[::-1])
                    for k, v in super().batch_at(state, rows).items()}

    return Reversed(**dataclasses.asdict(source))


def train_mesh_single(torch, dev, name, layers, policy, out_dir, reverse=False, arch=LM_ARCH):
    """A run of TRAIN_MESH_RUNS on one device (the reference of the mesh
    runs): the instrumented rows, the first forward's planes and the
    digests of each rank's rows of them, peak memory, bytes; for "12a_cut"
    the masters after the first step too.  ``reverse``: the same run with the rows of every
    batch in reverse order, its rows only (how far the device's own float
    sums move each reading: the noise floor of the mesh's differences)."""
    from repro_torch.models import ShardLayout

    cfg, tcfg, source = train_mesh_config(layers, policy, arch)
    if reverse:
        source = reversed_rows(source)
    # a run's trainer and its instrumented step refer to each other: the
    # cycle holds the last state until the collector frees it
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows, box, kept = [], {}, {"snapshot": name == "12a_cut" and not reverse}
    tr = train_mesh_trainer(torch, dev, cfg, tcfg, source, ShardLayout(), rows, box, kept,
                            record=not reverse)
    state, ds = tr.restore_or_init()
    nbytes = state_bytes(state)
    res = tr.run(state, ds)
    if reverse:
        del state, kept, tr
        gc.collect()
        torch.cuda.empty_cache()
        return {"rows": rows, "losses": res.losses}
    out = {"rows": rows, "losses": res.losses, "peak_memory_bytes":
           max(kept.get("run_peak", 0), torch.cuda.max_memory_allocated()),
           "step_peak_memory_bytes": max(row["peak"] for row in rows),
           "bytes": nbytes, "digests": box["digests"],
           "slice_digests": box["slice_digests"], "planes": box["planes"],
           "vs_plain": operands_vs_plain(torch, box.pop("operands"))}
    if name == "12a_cut":
        torch.save({p: t.cpu() for p, t in kept["params_after_first"].items()},
                   os.path.join(out_dir, "single_cut_params.pt"))
    del state, kept, tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_diffs(row: dict, ref: dict) -> dict:
    """The relative differences of one step's readings ``row`` from the
    same step's ``ref``: loss, grad_norm, the largest over the leaves of
    the sums of squares and of the gradients' sums of squares, and the
    leaf of the latter."""
    m, sm = row["metrics"], ref["metrics"]
    g, sg = row["grad_sumsq"], ref["grad_sumsq"]
    return {"loss": abs(m["loss"] / sm["loss"] - 1),
            "grad_norm": abs(m["grad_norm"] / sm["grad_norm"] - 1),
            "sumsq": rel_diff(row["sumsq"], ref["sumsq"]),
            "grad_sumsq": rel_diff(g, sg),
            "grad_sumsq_leaf": max(sg, key=lambda p: abs(g[p] / sg[p] - 1) if sg[p] else 0.0)}


def rel_diff(got: dict, want: dict) -> float:
    """The largest relative difference over the keys of ``want`` (an exact
    zero must stay zero)."""
    return max((abs(got[k] / v - 1) if v else abs(got[k])) for k, v in want.items())


def phase12(torch, dev, fault: bool = False):
    """Phase 12 (see the module docstring): the single-device reference
    runs, then TRAIN_MESH_WORLD ranks of ``--train-mesh-rank`` sharing the
    card over gloo (one card each over NCCL where the machine has them),
    then ``launch.train`` on 4 ranks.  ``fault``: the ranks run
    :func:`fault_norm_sum`'s faulty step (its readings print; the checks
    must fail).  Returns (the report, {kernel: {sub-phase: rank 0's
    launches per step}})."""
    import shutil

    from repro_torch.launch import mesh as mesh_mod

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "train_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    key, key32 = LM_POLICY_KERNELS["tnn"], "lowbit_gemm_tnn_i32"
    single = {}
    for _, arch, layers, policy, _, ref in TRAIN_MESH_RUNS:
        if ref not in single:
            single[ref] = train_mesh_single(torch, dev, ref, layers, policy, str(out_dir),
                                            arch=arch)
            single[ref]["floor"] = []
            if ref in TRAIN_MESH_FLOORS:
                rev = train_mesh_single(torch, dev, ref, layers, policy, str(out_dir),
                                        reverse=True, arch=arch)
                single[ref]["floor"] = [step_diffs(row, srow) for row, srow in
                                        zip(rev["rows"], single[ref]["rows"])]
    torch.save(single, out_dir / "single.pt")
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.setdefault("OMP_NUM_THREADS", "2")      # 4 ranks on the host's 8 cores
    # 4 ranks' caching allocators share the card: unallocated reserved
    # blocks of one are memory the others lack (12f's AdamW)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    res = mesh_mod.run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--train-mesh-rank",
                              str(out_dir)] + (["--train-mesh-fault"] if fault else []),
                             TRAIN_MESH_WORLD, timeout_s=TRAIN_MESH_TIMEOUT_S,
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
        for name, arch, layers, policy, rules, ref_name in TRAIN_MESH_RUNS:
            got, ref = rep[name], single[ref_name]
            for i, (row, srow) in enumerate(zip(got["rows"], ref["rows"])):
                m, sm = row["metrics"], srow["metrics"]
                tol = TRAIN_MESH_BOUNDS[name][i]
                d = step_diffs(row, srow)
                d_loss, d_gn, d_sq, d_g = d["loss"], d["grad_norm"], d["sumsq"], d["grad_sumsq"]
                diag.append(f"{name} rank {r} step {i}: loss {m['loss']} vs {sm['loss']} "
                            f"({d_loss:.2e}), grad_norm ({d_gn:.2e}), sums of squares "
                            f"(max {d_sq:.2e}), gradients' sums of squares (max {d_g:.2e}, "
                            f"{d['grad_sumsq_leaf']})")
                if row["launches"] != got["launches_expected"]:
                    failures.append(f"{name} rank {r} step {i}: launched {row['launches']}, "
                                    f"expected {got['launches_expected']}")
                coll = {k: row["collectives"].get(k, 0) for k in got["collectives_expected"]}
                if coll != got["collectives_expected"]:
                    failures.append(f"{name} rank {r} step {i}: collectives {coll}, expected "
                                    f"{got['collectives_expected']}")
                if d_loss > tol["loss"] or d_gn > tol["grad_norm"] or d_g > tol["grad_sumsq"] \
                        or (tol["sumsq"] is not None and d_sq > tol["sumsq"]):
                    failures.append(f"{name} rank {r} step {i}: outside {tol}")
            diag.append(f"{name} rank {r}: {got['n_digests']} projections through qmm, first "
                        f"differing planes at {got['first_differing_digest']}; first layer's "
                        f"planes equal {got['planes_equal']}")
            if not (got["digests_equal"] and got["planes_equal"]):
                failures.append(f"{name} rank {r}: the first forward's planes differ from one "
                                f"device's (first at projection {got['first_differing_digest']})")
            if got["n_digests"] != got["n_digests_expected"]:
                failures.append(f"{name} rank {r}: {got['n_digests']} qmm projections in the "
                                f"first forward, expected {got['n_digests_expected']}")
            vp = got["vs_plain"]
            diag.append(f"{name} rank {r}: the GeMM (row 1; rows 8 / 9 under int8 / int4) vs "
                        f"plain at the first forward's operands {vp['shapes']}: {vp['equal']}")
            n_keep = min(TRAIN_MESH_KEEP, got["n_digests_expected"])
            if len(vp["equal"]) != n_keep or not all(vp["equal"]):
                failures.append(f"{name} rank {r}: the GeMM differs from its plain version at "
                                f"the mesh's operands: {vp}")
            rp, out_eq = got["row_parallel"], got["outputs_vs_one_device"]
            if got["tp"] and policy != "f32":
                cfg_r = train_mesh_config(layers, policy, arch)[0]
                diag.append(f"{name} rank {r}: the int32 core vs plain at the row-parallel operands "
                            f"{rp and rp['shapes']}: {rp and rp['vs_plain']}; reduced counts "
                            f"== one device's core: {rp and rp['vs_one_device']}; the first "
                            f"column-parallel outputs == one device's rows: {out_eq}")
                if rp is None or len(rp["vs_plain"]) != tp_row_calls(cfg_r) or not (
                        all(rp["vs_plain"]) and all(rp["vs_one_device"])):
                    failures.append(f"{name} rank {r}: row-parallel check failed: {rp}")
                if out_eq is None or len(out_eq) != n_keep or not all(out_eq):
                    failures.append(f"{name} rank {r}: the first column-parallel outputs differ "
                                    f"from one device's rows: {out_eq}")
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
    for ref_name, one in single.items():
        for i, f in enumerate(one["floor"]):
            diag.append(f"{ref_name} one device with its rows reversed, step {i}: loss "
                        f"({f['loss']:.2e}), grad_norm ({f['grad_norm']:.2e}), sums of squares "
                        f"(max {f['sumsq']:.2e}), gradients' sums of squares (max "
                        f"{f['grad_sumsq']:.2e}, {f['grad_sumsq_leaf']})")
        vp = one["vs_plain"]
        if one["digests"] and (len(vp["equal"]) != len(one["planes"]) or not all(vp["equal"])):
            failures.append(f"{ref_name} one device: row 1 differs from its plain version: {vp}")
    for line in diag:
        log("[train mesh check] " + line)
    if failures:
        raise AssertionError("phase 12:\n" + "\n".join(failures))
    r0 = reps[0]
    a, sa = r0["12a"], single["12a"]
    step_s = a["rows"][-1]["s"]
    coll = a["rows"][-1]["collectives"]
    coll_s = sum(v for k, v in coll.items() if k.endswith("_s"))
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
                "step_peak_memory_bytes": [rep["12a"]["step_peak_memory_bytes"]
                                           for rep in reps],
                "single_peak_memory_bytes": sa["peak_memory_bytes"],
                "single_step_peak_memory_bytes": sa["step_peak_memory_bytes"],
                "single_bytes": sa["bytes"], "rank_bytes": [rep["12a"]["bytes"] for rep in reps],
                "collectives_per_step": coll, "collective_s_share": coll_s / step_s,
                "row_parallel": a["row_parallel"], "init_s": a["init_s"]},
        "12a_cut": {"elementwise": [rep["12a_cut"]["elementwise"] for rep in reps],
                    "losses": r0["12a_cut"]["losses"],
                    "single_losses": single["12a_cut"]["losses"],
                    "collectives_per_step": r0["12a_cut"]["rows"][-1]["collectives"]},
        "12a_f32": {"losses": r0["12a_f32"]["losses"],
                    "single_losses": single["12a_f32"]["losses"],
                    "collectives_per_step": r0["12a_f32"]["rows"][-1]["collectives"]},
        "12d": {"losses": r0["12d"]["losses"], "step_s": [row["s"] for row in
                                                          r0["12d"]["rows"]],
                "launches_per_step": r0["12d"]["rows"][-1]["launches"],
                "collectives_per_step": r0["12d"]["rows"][-1]["collectives"],
                "peak_memory_bytes": [rep["12d"]["peak_memory_bytes"] for rep in reps]},
        **{name: {"losses": r0[name]["losses"], "single_losses": single[name]["losses"],
                  "step_s": [row["s"] for row in r0[name]["rows"]],
                  "rank_step_s": [[row["s"] for row in rep[name]["rows"]] for rep in reps],
                  "single_step_s": [row["s"] for row in single[name]["rows"]],
                  "launches_per_step": r0[name]["rows"][-1]["launches"],
                  "launches_expected": r0[name]["launches_expected"],
                  "collectives_per_step": r0[name]["rows"][-1]["collectives"],
                  "peak_memory_bytes": [rep[name]["peak_memory_bytes"] for rep in reps],
                  "step_peak_memory_bytes": [rep[name]["step_peak_memory_bytes"]
                                             for rep in reps],
                  "start_allocated_bytes": [rep[name]["start_allocated_bytes"] for rep in reps],
                  "single_peak_memory_bytes": single[name]["peak_memory_bytes"],
                  "single_bytes": single[name]["bytes"],
                  "rank_bytes": [rep[name]["bytes"] for rep in reps],
                  "bytes_ratio": [{k: v / single[name]["bytes"][k] for k, v in
                                   rep[name]["bytes"].items()} for rep in reps],
                  "outputs_vs_one_device": r0[name]["outputs_vs_one_device"],
                  "row_parallel": r0[name]["row_parallel"]}
           for name in ("12e", "12f", "12g", "12h")},
        "rel_diff_vs_one_device": {
            name: [step_diffs(row, srow)
                   for row, srow in zip(r0[name]["rows"], single[ref]["rows"])]
            for name, _, _, _, _, ref in TRAIN_MESH_RUNS},
        "one_device_rows_reversed": {ref: one["floor"] for ref, one in single.items()},
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
    launches = {k: {name: r0[name]["rows"][-1]["launches"].get(k, 0)
                    for name in ("12a", "12a_cut", "12d", "12e", "12f")} for k in (key, key32)}
    for name, policy in (("12g", "int8"), ("12h", "int4")):
        k = LM_POLICY_KERNELS[policy]
        launches[k] = {name: r0[name]["rows"][-1]["launches"].get(k, 0)}
    return report, launches


def dry_run(torch, fn, args):
    """``fn(*args)`` on ``meta`` tensors under ``roofline.op_stats.counting``;
    returns (its output, the OpStats, the training mesh's raw collective
    counters, the serving mesh's)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import qmm_mesh
    from repro_torch.roofline import op_stats

    with op_stats.counting(args) as stats:
        out = fn(*args)
    strip = lambda d: {k: v for k, v in d.items() if not k.endswith("_s")}  # noqa: E731
    return out, stats, strip(mesh_mod.collectives()), strip(qmm_mesh.collectives())


def dry_lm(torch):
    """13a's LM half on ``meta``: 7a's packed TinyLlama-1.1B (``tnn``), a
    LM_BATCH x LM_PROMPT prefill, then one decode step against the
    LM_PROMPT + LM_STEPS cache.  -> (cfg, prefill stats, decode stats)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.kvcache import init_caches
    from repro_torch.models.packing import pack_lm_params

    meta, lay = torch.device("meta"), ShardLayout()
    cfg = get_config(LM_ARCH, quant_policy="tnn")
    packed = pack_lm_params(model.init_lm(torch.Generator(), cfg, lay, dtype=cfg.dtype,
                                          device=meta), cfg)
    caches = init_caches(cfg, lay, LM_BATCH, LM_PROMPT + LM_STEPS, device=meta)
    prompt = torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int64, device=meta)
    with torch.no_grad():
        (_, caches), pre, _, _ = dry_run(
            torch, lambda p, c, t: model.prefill(p, {"tokens": t}, c, cfg, lay),
            (packed, caches, prompt))
        tok = torch.empty((LM_BATCH, 1), dtype=torch.int64, device=meta)
        _, dec, _, _ = dry_run(
            torch, lambda p, c, t: model.decode_step(p, {"tokens": t}, c, LM_PROMPT, cfg, lay),
            (packed, caches, tok))
    return cfg, pre, dec


def dry_train(torch, cfg, tcfg, layout, rows, mesh=None):
    """One train step of ``cfg`` on ``meta`` at ``rows`` x TRAIN_SEQ tokens
    (on ``mesh`` under TRAIN_RULES when given: the state holds rank 0's
    shards).  -> (OpStats, state bytes, the mesh's collectives, the
    state's shardings or None)."""
    from repro_torch.parallel import sharding
    from repro_torch.roofline import op_stats
    from repro_torch.train.train_step import init_train_state, make_train_step, state_shardings

    meta = torch.device("meta")
    batch = {"tokens": torch.empty((rows, TRAIN_SEQ), dtype=torch.int32, device=meta),
             "labels": torch.empty((rows, TRAIN_SEQ), dtype=torch.int32, device=meta),
             "mask": torch.empty((rows, TRAIN_SEQ), dtype=torch.float32, device=meta)}
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        sh = state_shardings(cfg, layout, tcfg) if mesh is not None else None
        state = init_train_state(torch.Generator(), cfg, layout, tcfg, device=meta,
                                 shardings=sh)
        step = make_train_step(cfg, layout, tcfg)
        # the step's plans come from a whole-shape meta skeleton: built
        # outside the count, as the card's first step builds them
        step.prepare(sharding.active(), TRAIN_SEQ)
        _, stats, coll, _ = dry_run(torch, step, (state, batch))
    return stats, op_stats.tree_bytes(state), coll, sh


def dry_serve_mesh(torch):
    """11c's serving forward on a placeholder (1, 4) under the engine's
    ``serve_lowbit`` rules: 7a's TinyLlama-1.1B packed under the mesh (rank
    0's plane slices), one LM_BATCH x MESH_PROMPT prefill.  -> (cfg,
    OpStats, the serving mesh's collectives)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models import ShardLayout, model
    from repro_torch.models.kvcache import init_caches
    from repro_torch.models.packing import pack_lm_params
    from repro_torch.parallel import sharding

    meta, lay = torch.device("meta"), ShardLayout()
    cfg = get_config(LM_ARCH, quant_policy="tnn")
    mesh = PlaceholderMesh((1, MESH_WORLD), ("data", "model"))
    with sharding.use_mesh(mesh, sharding.RULESETS["serve_lowbit"]), torch.no_grad():
        packed = pack_lm_params(model.init_lm(torch.Generator(), cfg, lay, dtype=cfg.dtype,
                                              device=meta), cfg)
        caches = init_caches(cfg, lay, MESH_REQUESTS, MESH_PROMPT + MESH_NEW, device=meta)
        prompt = torch.empty((MESH_REQUESTS, MESH_PROMPT), dtype=torch.int64, device=meta)
        _, stats, _, serve = dry_run(
            torch, lambda p, c, t: model.prefill(p, {"tokens": t}, c, cfg, lay),
            (packed, caches, prompt))
    return cfg, stats, serve


def roofline_ms(stats, max_sm_mhz: float) -> dict:
    """The roofline terms (ms) of one dry-run's OpStats on this card."""
    A = roofline()
    t = A.roofline_from_artifact({"cost": {"flops": stats.dot_flops,
                                           "bytes accessed": stats.hbm_bytes},
                                  "static": stats.as_dict(), "num_devices": 1},
                                 A.HW(sm_clock_hz=max_sm_mhz * 1e6))
    return {"step_ms": t.step_time_s * 1e3, "compute_ms": t.compute_s * 1e3,
            "memory_ms": t.memory_s * 1e3, "collective_ms": t.collective_s * 1e3,
            "dominant": t.dominant,
            "compute_ms_by_class": {k: v * 1e3 for k, v in t.compute_s_by_class.items()}}


def card_readings(a7: dict, t10: dict, t12: dict = None, m11c: dict = None) -> dict:
    """What phase 13 holds the dry-run against, from the reports of phases
    7a and 10a and, in the full script, 12 (12a, 12e to 12h) and 11c."""
    out = {"forward_launches": {k: v // (1 + LM_STEPS) for k, v in a7["launches"].items()},
           "decode_ms": a7["tnn_decode_ms_per_token"],
           "step_launches": {LM_POLICY_KERNELS["tnn"]: t10["fused_tnn_launches_per_step"]},
           "step_ms": t10["mean_step_ms"], "step_peak_bytes": t10["peak_memory_bytes"]}
    if t12 is not None:
        for name in ("12a", "12e", "12f", "12g", "12h"):
            run = t12[name]
            out[f"mesh{name}"] = {"collectives": {k: v for k, v in
                                                  run["collectives_per_step"].items()
                                                  if not k.endswith("_s")},
                                  "launches": run["launches_per_step"],
                                  "state_bytes": sum(run["rank_bytes"][0].values()),
                                  "peak_bytes": run["peak_memory_bytes"][0]}
    if m11c is not None:
        out["mesh11c"] = m11c["per_forward"]
    return out


def phase13(torch, dev, measured: dict, max_sm_mhz: float) -> dict:
    """Phase 13 (see the module docstring): the dry-run's counts on
    ``meta`` against the card's readings in ``measured``
    (:func:`card_readings` of phases 7a, 10a and, in the full script, 11c
    and 12a), the production cells, the examples on the card.  Any mismatch raises."""
    import math

    from repro_torch.data.pipeline import mesh_rows
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PlaceholderMesh
    from repro_torch.models import ShardLayout
    from repro_torch.models.common import train_layout
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding
    from repro_torch.train import TrainStepConfig

    t_phase = time.perf_counter()
    report = {}
    key = LM_POLICY_KERNELS["tnn"]
    # -- 13a. kernel records against launches; the step's float operations ------
    t0 = time.perf_counter()
    cfg, pre, dec = dry_lm(torch)
    per_forward = tnn_gemms_per_forward(cfg)
    for what, st in (("prefill", pre), ("decode step", dec)):
        if st.kernels != measured["forward_launches"] or st.kernels != {key: per_forward}:
            raise AssertionError(f"13a {what}: records {st.kernels}, launches per forward on "
                                 f"the card {measured['forward_launches']}")
    cfg10 = cfg.with_(remat=True)
    tcfg10 = TrainStepConfig(optimizer=AdamWConfig(lr=3e-4, warmup_steps=1))
    step, _, _, _ = dry_train(torch, cfg10, tcfg10, ShardLayout(), TRAIN_BATCH)
    flops = train_flops(cfg10, TRAIN_BATCH, TRAIN_SEQ)
    if step.kernels != measured["step_launches"] or step.kernels != {key: 2 * per_forward}:
        raise AssertionError(f"13a step: records {step.kernels}, launches on the card "
                             f"{measured['step_launches']}")
    if step.dot_flops != flops:
        raise AssertionError(f"13a step: {step.dot_flops} float operations, train_flops "
                             f"{flops}")
    report["13a"] = {"prefill_records": pre.kernels, "decode_records": dec.kernels,
                     "step_records": step.kernels, "step_flops": step.dot_flops,
                     "step_flops_by_dtype": step.dot_flops_by_dtype,
                     "card_forward_launches": measured["forward_launches"],
                     "card_step_launches": measured["step_launches"],
                     "s": time.perf_counter() - t0}
    log("[dryrun 13a] " + json.dumps(report["13a"]))
    # -- 13b. the placeholder meshes against the real ones ------------------------
    t0 = time.perf_counter()
    cfg12, tcfg12, _ = train_mesh_config(TRAIN_MESH_LAYERS)
    mesh = PlaceholderMesh(TRAIN_MESH_SHAPE, ("data", "model"))
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        coord, shards = sharding.mesh_coord(mesh, sharding.batch_axes())
        layout = train_layout()
    rows = len(mesh_rows(TRAIN_BATCH, coord, shards, tcfg12.microbatch))
    mstep, state_bytes_, mcoll, sh = dry_train(torch, cfg12, tcfg12, layout, rows, mesh)
    with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
        expect = train_mesh_collectives(cfg12, tcfg12, sh, mesh, "tnn")
    got = {k: mcoll.get(k, 0) for k in expect}
    want_records = train_mesh_launches(cfg12, "tnn", layout.tp > 1)
    if got != expect or mstep.kernels != want_records:
        raise AssertionError(f"13b (2, 2): collectives {got}, records {mstep.kernels}; "
                             f"train_mesh_collectives {expect}, records {want_records}")
    # each rank's float products: its rows and its 1/tp of the heads, FFN and
    # vocab, a quarter of one device's step at 12a's depth on (2, 2)
    rank_flops = roofline().train_step_flops(cfg12, rows, TRAIN_SEQ, layout.tp)
    share = mstep.dot_flops / roofline().train_step_flops(cfg12, TRAIN_BATCH, TRAIN_SEQ)
    if mstep.dot_flops != rank_flops or abs(share - 0.25) > 0.01 * 0.25:
        raise AssertionError(f"13b (2, 2): {mstep.dot_flops} float operations per rank, "
                             f"train_step_flops {rank_flops}, {share:.4f} of one device's")
    m12 = measured.get("mesh12a")
    if m12 is not None and mcoll != m12["collectives"]:
        raise AssertionError(f"13b (2, 2): collectives {mcoll}, 12a's rank 0 "
                             f"{m12['collectives']}")
    # 12e's to 12h's configurations on the placeholder (2, 2): their
    # predicted collectives and launches, and, in the full script, rank 0's
    meshes = {}
    for name, arch, layers, policy in (("12e", MOE_ARCH, MOE_MESH_LAYERS, "tnn"),
                                       ("12f", SSM_ARCH, None, "tnn"),
                                       ("12g", LM_ARCH, TRAIN_MESH_LAYERS, "int8"),
                                       ("12h", LM_ARCH, LM_CUT_LAYERS, "int4")):
        cfg_x, tcfg_x, _ = train_mesh_config(layers, policy, arch)
        xstep, xbytes, xcoll, xsh = dry_train(torch, cfg_x, tcfg_x, layout, rows, mesh)
        with sharding.use_mesh(mesh, sharding.TRAIN_RULES):
            xexpect = train_mesh_collectives(cfg_x, tcfg_x, xsh, mesh, policy)
        xrec = train_mesh_launches(cfg_x, policy, True)
        if {k: xcoll.get(k, 0) for k in xexpect} != xexpect or xstep.kernels != xrec:
            raise AssertionError(f"13b {name} (2, 2): collectives {xcoll}, records "
                                 f"{xstep.kernels}; train_mesh_collectives {xexpect}, "
                                 f"records {xrec}")
        card = measured.get(f"mesh{name}")
        if card is not None and (xcoll != card["collectives"] or xbytes != card["state_bytes"]
                                 or xstep.kernels != card["launches"]):
            raise AssertionError(f"13b/13c {name} (2, 2): collectives {xcoll}, state bytes "
                                 f"{xbytes}, records {xstep.kernels}; {name}'s rank 0 "
                                 f"{card['collectives']}, {card['state_bytes']}, launches "
                                 f"{card['launches']}")
        meshes[name] = {"collectives": xcoll, "state_bytes": xbytes, "records": xstep.kernels,
                        "rank_flops": xstep.dot_flops,
                        "card": None if card is None else
                        {k: card[k] for k in ("collectives", "state_bytes", "launches")}}
    cfg11, serve, scoll = dry_serve_mesh(torch)
    want_l, want_c = mesh_expect(cfg11, 1, 5, 2, 5)
    got_c = {k: scoll.get(k, 0) for k in want_c}
    if serve.kernels != want_l or got_c != want_c:
        raise AssertionError(f"13b (1, 4): records {serve.kernels}, collectives {scoll}; "
                             f"expected {want_l}, {want_c}")
    m11 = measured.get("mesh11c")
    if m11 is not None and m11 != {"fused": want_l["lowbit_gemm_tnn_fused"],
                                   "i32": want_l["lowbit_gemm_tnn_i32"],
                                   "all_reduce": want_c["all_reduce"]}:
        raise AssertionError(f"13b (1, 4): 11c counted {m11} per forward")
    report["13b"] = {"train_2x2": mcoll, "expected": expect, "rank_flops": mstep.dot_flops,
                     "rank_flops_share": share,
                     "card_12a": None if m12 is None else m12["collectives"],
                     "records_2x2": mstep.kernels, "serve_1x4_records": serve.kernels,
                     "serve_1x4_collectives": scoll, "card_11c": m11,
                     "moe_ssm_2x2": meshes, "s": time.perf_counter() - t0}
    log("[dryrun 13b] " + json.dumps(report["13b"]))
    # -- 13c. memory ---------------------------------------------------------------
    lo, hi = DRYRUN_PEAK_BAND
    ratios = {"10a": step.peak_live_bytes / measured["step_peak_bytes"]}
    if m12 is not None:
        if state_bytes_ != m12["state_bytes"]:
            raise AssertionError(f"13c: state bytes per rank {state_bytes_}, 12a's rank 0 "
                                 f"{m12['state_bytes']}")
        ratios["12a"] = mstep.peak_live_bytes / m12["peak_bytes"]
    for what, r in ratios.items():
        if not lo <= r <= hi:
            raise AssertionError(f"13c: {what} peak estimate / measured {r:.3f} outside "
                                 f"[{lo}, {hi}]")
    report["13c"] = {"state_bytes_per_rank": state_bytes_,
                     "card_12a_state_bytes": None if m12 is None else m12["state_bytes"],
                     "peak_estimate_10a": step.peak_live_bytes,
                     "card_10a_peak": measured["step_peak_bytes"],
                     "peak_estimate_12a": mstep.peak_live_bytes,
                     "card_12a_peak": None if m12 is None else m12["peak_bytes"],
                     "ratio_estimate_over_card": ratios}
    log("[dryrun 13c] " + json.dumps(report["13c"]))
    # -- 13d. the roofline against measured time -----------------------------------
    terms = {"10a_step": roofline_ms(step, max_sm_mhz), "7a_decode": roofline_ms(dec, max_sm_mhz)}
    meas = {"10a_step": measured["step_ms"], "7a_decode": measured["decode_ms"]}
    ratio = {k: meas[k] / terms[k]["step_ms"] for k in terms}
    for k, r in ratio.items():
        if not r >= 1:
            raise AssertionError(f"13d: {k} measured {meas[k]:.3f} ms under its roofline "
                                 f"{terms[k]['step_ms']:.3f} ms: a count is wrong")
    f32_ms = roofline().Work({"f32": step.dot_flops}).compute_s() * 1e3
    report["13d"] = {"roofline": terms, "measured_ms": meas, "measured_over_roofline": ratio,
                     "step_float32_bound_ms": f32_ms,
                     "step_measured_over_float32_bound": meas["10a_step"] / f32_ms}
    log("[dryrun 13d] " + json.dumps(report["13d"]))
    # -- 13e. the production cells -------------------------------------------------
    # one subprocess a cell (host work on meta tensors), all at once
    from concurrent.futures import ThreadPoolExecutor

    out_dir = str(ROOT / "build" / "chip_smoke" / "dryrun")

    def cell(mesh_name, shape):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(LM_ARCH, shape, mesh_name, out_dir, force=True,
                              timeout=DRYRUN_CELL_TIMEOUT_S)
        return mesh_name, shape, rec, time.perf_counter() - t0

    grid = list(itertools.product(DRYRUN_MESHES, DRYRUN_CELLS))
    with ThreadPoolExecutor(len(grid)) as ex:
        done = list(ex.map(lambda args: cell(*args), grid))
    cells = {}
    for mesh_name, shape, rec, secs in done:
        if rec["status"] != "PASS":
            raise AssertionError(f"13e {mesh_name} {shape}: {rec.get('error')}")
        cells[f"{mesh_name}/{shape}"] = {
            "s": secs, "trace_s": rec["trace_s"],
            "flops": rec["cost"]["flops"], "bytes_accessed": rec["cost"]["bytes accessed"],
            "peak_live_bytes": rec["memory"]["peak_live_bytes"],
            "collective_bytes": rec["collectives"]["total"]}
    report["13e"] = cells
    log("[dryrun 13e] " + json.dumps(cells))
    # -- 13f. the examples on the card ----------------------------------------------
    from repro_torch.examples import quickstart, serve_batch, train_tinylm

    t0 = time.perf_counter()
    q = quickstart.main(["--device", "cuda"])
    if not q["tbn_exact"]:
        raise AssertionError("13f quickstart: TBN core differs from the float reference")
    res = serve_batch.main(EXAMPLE_SERVE_ARGS + ["--device", "cuda"])
    if len(res) != int(EXAMPLE_SERVE_ARGS[EXAMPLE_SERVE_ARGS.index("--requests") + 1]) or \
            any(r.status != "ok" for r in res.values()):
        raise AssertionError(f"13f serve_batch: {[(u, r.status) for u, r in res.items()]}")
    ck = ROOT / "build" / "chip_smoke" / "tinylm_ckpt"
    tr = train_tinylm.main(EXAMPLE_TRAIN_ARGS + ["--device", "cuda", "--checkpoint-dir",
                                                 str(ck)])
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    vocab = int(EXAMPLE_TRAIN_ARGS[EXAMPLE_TRAIN_ARGS.index("--vocab") + 1])
    last = sum(tr.losses[-10:]) / min(10, len(tr.losses))
    if not last < math.log(vocab):
        raise AssertionError(f"13f train_tinylm: loss {last} not below ln(V)")
    report["13f"] = {"quickstart": q, "serve_batch_requests": len(res),
                     "train_tinylm_first_last": [tr.losses[0], last],
                     "s": time.perf_counter() - t0}
    log("[dryrun 13f] " + json.dumps(report["13f"]))
    report["phase_s"] = time.perf_counter() - t_phase
    if report["phase_s"] > DRYRUN_PHASE_S:
        raise AssertionError(f"phase 13 took {report['phase_s']:.1f} s, over "
                             f"{DRYRUN_PHASE_S} s")
    return report


def dryrun_only(torch) -> int:
    """``--dryrun``: phases 1, 2, 7a, 10a and 13 (the mesh readings of 11c
    and 12a need those phases: 13b then holds the placeholder meshes to the
    formulas only)."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, max_sm_mhz = device_and_build(torch, _build)
    from repro_torch.tune import cache as plan_cache

    plan_cache.set_cache_path(str(ROOT / "build" / "chip_smoke" / "tune_plans.json"))
    lm_report, _, _ = lm_phase(torch, dev, only_7a=True)
    train_report, _ = phase10(torch, dev, only_10a=True)
    report = phase13(torch, dev, card_readings(lm_report["7a"], train_report["10a"]),
                     max_sm_mhz)
    log(f"[dryrun] phase 13 {report['phase_s']:.1f} s")
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


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


def train_mesh_only(torch, fault: bool = False) -> int:
    """``--train-mesh``: phases 1, 2 and 12 (``fault``: 12 with the faulty
    step of :func:`fault_norm_sum`)."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind, card, _ = device_and_build(torch, _build)
    report, launches = phase12(torch, dev, fault=fault)
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
    parser.add_argument("--train-mesh-fault", action="store_true",
                        help="with --train-mesh: the ranks' norm scales sum their gradients "
                             "over the batch axes only, and under int8 / int4 each rank "
                             "calibrates a weight's grid on its chunk (the faulty steps "
                             "TRAIN_MESH_BOUNDS must reject); the phase prints its readings "
                             "and fails")
    parser.add_argument("--dryrun", action="store_true",
                        help="run only the device and build phases, 7a, 10a and "
                             "phase 13")
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
        return train_mesh_rank(torch, args.train_mesh_rank, fault=args.train_mesh_fault)
    if args.train_mesh:
        return train_mesh_only(torch, fault=args.train_mesh_fault)
    if args.dryrun:
        return dryrun_only(torch)
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
        for first in ("conv_stats", "conv_pack"):
            if launches.get(f"{first}_{m}", 0) != launches[f"lowbit_conv_{m}"]:
                raise AssertionError(f"main path: {launches.get(f'{first}_{m}', 0)} "
                                     f"{first} for {launches[f'lowbit_conv_{m}']} {m} convs")
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
    # -- 13. the dry-run against phases 7a, 10a, 11c and 12a (before any
    # profiler session) ---------------------------------------------------------
    dry_report = phase13(torch, dev, card_readings(
        lm_report["7a"], train_report["10a"], tmesh_report, mesh_report["11c"]),
        max_sm_mhz)
    log(f"[dryrun] phase 13 {dry_report['phase_s']:.1f} s")
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

    # where one CNN batch's device time goes, by kernel: the repository's
    # kernels by name (the statistics, the packing pass, the conv kernels),
    # the rest is PyTorch's own (ReLU, max-pool, the float first layer)
    def by_kernel(rows):
        ours = {k: sum(ms for name, ms, _ in rows if k in name)
                for k in ("act_stats_kernel", "conv_pack_kernel", "lowbit_conv_kernel",
                          "dense_conv_kernel")}
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
            words = planes[0].shape[1]
            b_ms, b_by = work_bound(roofline().conv_fused_work(
                mode, b, h, w, cin, kh, kw_, oh, ow, cout, words, dense=tc), max_sm_mhz)
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
            bb, hh, ww, cc = x.shape
            hp, wp = conv_fused.conv_pack_cuda(*args)[0].shape[1:3]
            b_ms, _ = work_bound(roofline().conv_pack_work(mode, bb, hh, ww, cc, hp, wp))
            bound_ms += b_ms
            shp.append(list(x.shape))
        name = f"conv_pack_{mode}"
        kernels.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE, "replaces": PACK_REPLACES,
            "launches": launches.get(name, 0), "launches_dense_path": launches2.get(name, 0),
            "max_abs_err": check.max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "device_ms": device_ms or None, "shapes_bhwc": shp})

    kernels.extend(stats_rows(
        dev, gen, {m: [(x, *qt.geometry[:2], stride) for x, qt, stride, _, _ in conv_layers(m)]
                   for m in MODES}, launches, launches2, check))

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
    c12 = t12["collectives_per_step"]
    log(f"[train mesh] {TRAIN_MESH_WORLD} ranks on {torch.cuda.device_count()} card(s) over "
        f"{tmesh_report['backend']}, mesh {TRAIN_MESH_SHAPE} TRAIN_RULES (heads, FFN, vocab "
        f"and the sequence over \"model\"): 12a {LM_ARCH} QAT (tnn, remat, int8 moments, EF, "
        f"bf16 wire) {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"{t12['step_s'][-1] * 1e3:.1f} ms/step ({t12['tokens_per_s']:.1f} tokens/s; one "
        f"device {t12['single_step_s'][-1] * 1e3:.1f} ms), losses {t12['losses']} (one device "
        f"{t12['single_losses']}), {t12['launches_per_step']} per rank per step, collectives "
        f"{c12['all_gather']} / {c12['reduce_scatter']} / {c12['all_reduce']} "
        f"({c12['all_gather_bytes']} / {c12['reduce_scatter_bytes']} / "
        f"{c12['all_reduce_bytes']} bytes), {t12['collective_s_share']:.2f} of a step, peak "
        f"{max(t12['peak_memory_bytes']) / 1e9:.2f} GB a rank (one device "
        f"{t12['single_peak_memory_bytes'] / 1e9:.2f} GB), master/moment/EF bytes per rank "
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
