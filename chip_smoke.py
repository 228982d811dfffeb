#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the kernels from this checkout, holds every kernel
against its plain PyTorch version, drives the main path, times it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and count, ``nvidia-smi``'s name and power
   limit;
2. build — ``nvcc`` for ``sm_90a``, one process per ``csrc/*.cu``, and
   ``-Xptxas -v``'s register / shared-memory / spill lines;
3. GeMM kernel vs plain on the card — TNN/TBN/BNN, int32 core and fused
   (with and without bias), at every ``GEMM_GRID`` shape, a ragged depth
   and the CNN's im2col shapes: ``torch.equal``;
4. conv kernel vs plain — every ``PAPER_CNN`` low-bit layer geometry at
   full width, batch 8, in all three modes, plus a Cin % 32 != 0 and a
   stride-2 VALID geometry: ``torch.equal``;
5. the main path, launch counters zeroed just before and read just
   after: ``qmm`` and ``packed_matmul`` requests at the paper's GEMM_GRID
   diagonal in all three modes, then ``PaperCNN(PAPER_CNN)`` at full
   width (img 32, channels 32-64-128-128-256) on 4 batches of 256 images
   (the first a warm-up).  Every kernel must have launched; the logits
   must be finite; a batch must be ``torch.equal`` to the same module
   run through the plain versions, layer by layer; each low-bit layer
   must equal the materializing oracle (im2col + ``qmm``); a small CNN
   on the card must match the CPU run to 1e-5;
6. times — CUDA events after warm-up, per kernel x mode at the main
   path's shapes: kernel, plain version, the least time the card could
   take (popcounts at 16 per clock per SM on 132 SMs at the maximum SM
   clock, or bytes at 3.35 TB/s, whichever is larger) and one PyTorch
   call computing the same product on +-1/0 values (``library_ms``, a
   yardstick the port never calls), plus each kernel's own device time
   and one CNN batch's device time by kernel from ``torch.profiler``;
7. the last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
GEMM_SOURCE = "src/repro_torch/kernels/csrc/lowbit_gemm.cu"
CONV_SOURCE = "src/repro_torch/kernels/csrc/lowbit_conv.cu"
BATCH, BATCHES = 256, 4


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


def kernel_device_ms(fn, pattern: str):
    """Device ms of the kernels named like ``pattern`` in one ``fn()``,
    or None when the profiler recorded none."""
    total = sum(ms for name, ms, _ in profiled(fn)[0] if pattern in name)
    return total or None


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


def gemm_fns(mode):
    from repro_torch.kernels import bnn_matmul, tbn_matmul, tnn_matmul

    mod = {"tnn": tnn_matmul, "tbn": tbn_matmul, "bnn": bnn_matmul}[mode]
    return {v: getattr(mod, f"{mode}_matmul{v}") for v in
            ("_cuda", "_fused_cuda", "_torch", "_fused_torch")}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.cnn import PaperCNN
        from repro_torch.configs.paper_cnn import GEMM_GRID, PAPER_CNN, PAPER_CNN_SMOKE
        from repro_torch.core import conv as tconv
        from repro_torch.kernels import _build, conv_fused, ops
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

    check = Checker()
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 3. GeMM kernel vs plain -------------------------------------------
    t0 = time.perf_counter()
    grid = list(itertools.product(GEMM_GRID["height"], GEMM_GRID["width"],
                                  GEMM_GRID["depth"]))
    im2col = [(m, n, k) for _, m, n, k in cnn_gemm_shapes(PAPER_CNN, 8)]
    shapes = grid + [(37, 21, 130), (1, 1, 1)] + im2col
    for mode in MODES:
        fn = gemm_fns(mode)
        for m, n, k in shapes:
            a_pl, b_pl, row, col, bias = gemm_operands(mode, m, n, k, dev, gen)
            ops_ = a_pl + b_pl
            what = f"gemm {mode} {m}x{n}x{k}"
            check.equal(f"lowbit_gemm_{mode}_i32", fn["_cuda"](*ops_, k),
                        fn["_torch"](*ops_, k), what + " int32")
            check.equal(f"lowbit_gemm_{mode}_fused", fn["_fused_cuda"](*ops_, k, row, col),
                        fn["_fused_torch"](*ops_, k, row, col), what + " fused")
            check.equal(f"lowbit_gemm_{mode}_fused",
                        fn["_fused_cuda"](*ops_, k, row, col, bias),
                        fn["_fused_torch"](*ops_, k, row, col, bias), what + " fused+bias")
    torch.cuda.synchronize()
    log(f"[gemm] {len(shapes)} shapes x 3 modes x (int32, fused, fused+bias): kernel "
        f"== plain ({time.perf_counter() - t0:.1f} s)")

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
              ((8, 17, 17, 64), (3, 3, 64, 128), 2, "VALID")]
    for mode in MODES:
        for xs, fs, stride, padding in geoms:
            x = torch.randn(xs, generator=gen, device=dev)
            f = torch.randn(fs, generator=gen, device=dev)
            bias = torch.randn((fs[-1],), generator=gen, device=dev)
            for b in (None, bias):
                qt = tconv.pack_conv_filters(f, QuantMode(mode), bias=b)
                check.equal(f"lowbit_conv_{mode}",
                            ops.qconv(x, qt, stride=stride, padding=padding, backend="cuda"),
                            ops.qconv(x, qt, stride=stride, padding=padding, backend="torch"),
                            f"conv {mode} x{xs} f{fs} s{stride} {padding} "
                            f"bias={b is not None}")
    torch.cuda.synchronize()
    log(f"[conv] {len(geoms)} geometries x 3 modes x (no bias, bias): kernel == plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 5. the main path --------------------------------------------------
    rng = np.random.default_rng(0)
    requests = []
    for mode in MODES:
        for m, n, k in zip(GEMM_GRID["height"], GEMM_GRID["width"], GEMM_GRID["depth"]):
            x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dev)
            w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(dev)
            requests.append((mode, x, ops.pack_weights(w, QuantMode(mode))))
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
               [f"lowbit_conv_{m}" for m in MODES]
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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

    # -- 6. times ----------------------------------------------------------
    clk = max_sm_mhz * 1e6

    def bound(popc, nbytes):
        t_ops = popc / (SMS * POPC_PER_CLK_PER_SM * clk)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    # where one CNN batch's device time goes, by kernel
    rows, prof_ms = profiled(lambda: model(images[-1]))
    dev_ms = sum(r[1] for r in rows)
    batch_ms = cnn_s * 1e3 / (BATCHES - 1)
    log("[profile] " + json.dumps({
        "cnn_batch_ms_host": batch_ms, "cnn_batch_ms_host_profiled": prof_ms,
        "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / batch_ms,
        "top": [[name[:80], ms, calls] for name, ms, calls in rows[:12]]}))

    kernels = []
    for mode in MODES:
        fn = gemm_fns(mode)
        for fused in (True, False):
            ms = plain_ms = lib_ms = bound_ms = 0.0
            device_ms = 0.0
            by, shp = set(), []
            for rmode, x, qt in requests:
                if rmode != mode:
                    continue
                m, k = x.shape
                n = qt.out_features
                xa = ops.quantize_activations(x, qt.mode)
                a_pl = [xa[kk] for kk in ("plus", "minus", "bits") if kk in xa]
                b_pl = [qt.payload[kk] for kk in ("plus", "minus", "bits") if kk in qt.payload]
                row = xa["scale"].reshape(1, 1).expand(m, 1).contiguous()
                col = qt.scale.reshape(1, n)
                args = a_pl + b_pl + [k] + ([row, col] if fused else [])
                kfn = fn["_fused_cuda" if fused else "_cuda"]
                pfn = fn["_fused_torch" if fused else "_torch"]
                ms += cuda_ms(lambda: kfn(*args), reps=200)
                device_ms += kernel_device_ms(lambda: kfn(*args), "lowbit_gemm_kernel") or 0.0
                plain_ms += cuda_ms(lambda: pfn(*args), reps=10)
                av = ops._dense_values(a_pl, k, mode != "bnn").to(torch.bfloat16)
                bv = ops._dense_values(b_pl, k, mode == "tnn").to(torch.bfloat16).t()
                lib_ms += cuda_ms(lambda: torch.matmul(av, bv), reps=200)
                kw = a_pl[0].shape[1]
                nbytes = 4 * kw * (m * len(a_pl) + n * len(b_pl)) + 4 * m * n + \
                    (4 * (m + n) if fused else 0)
                b_ms, b_by = bound(m * n * kw * NPOPC[mode], nbytes)
                bound_ms += b_ms
                by.add(b_by)
                shp.append([m, n, k])
            name = f"lowbit_gemm_{mode}_{'fused' if fused else 'i32'}"
            kernels.append({
                "name": name, "route": "cuda", "source": GEMM_SOURCE,
                "replaces": GEMM_REPLACES[(mode, fused)],
                "launches": launches.get(name, 0), "max_abs_err": check.max_err[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if "operations" in by else "bytes",
                "library_ms": lib_ms, "device_ms": device_ms or None, "shapes_mnk": shp})

    for mode in MODES:
        ms = plain_ms = lib_ms = bound_ms = device_ms = 0.0
        by, shp = set(), []
        for i, (spec, layer) in enumerate(zip(PAPER_CNN.convs, model.layers)):
            if spec.mode != mode:
                continue
            x = layer_inputs[i].contiguous()
            qt = layer.packed
            kh, kw_, cin, cout = qt.geometry
            stats = conv_fused.conv_act_stats(x, qt.mode, kh, kw_, spec.stride, "SAME")
            planes = conv_fused.conv_weight_planes(qt)
            col = qt.scale.reshape(1, cout)
            args = (qt.mode, x, planes, qt.geometry, spec.stride, "SAME", stats, col, None)
            ms += cuda_ms(lambda: conv_fused.conv_fused_cuda(*args), reps=20)
            device_ms += kernel_device_ms(lambda: conv_fused.conv_fused_cuda(*args),
                                          "lowbit_conv_kernel") or 0.0
            plain_ms += cuda_ms(lambda: conv_fused.conv_fused_torch(*args), reps=3, warmup=1)
            xq = conv_fused.quantize_patch_values(x, qt.mode, stats.get("thr")) \
                .permute(0, 3, 1, 2).contiguous()
            wq = qt.to_dense().reshape(kh, kw_, cin, cout).permute(3, 2, 0, 1)
            wq = torch.sign(wq).contiguous()
            lib_ms += cuda_ms(lambda: F.conv2d(xq, wq, stride=spec.stride,
                                               padding=kh // 2), reps=20)
            b, h, w, _ = x.shape
            oh, ow, _, _ = conv_fused.conv_out_hw(h, w, kh, kw_, spec.stride, "SAME")
            m, words = b * oh * ow, planes[0].shape[1]
            nbytes = x.numel() * 4 + 4 * cout * words * len(planes) + 4 * m * cout
            b_ms, b_by = bound(m * cout * words * NPOPC[mode], nbytes)
            bound_ms += b_ms
            by.add(b_by)
            shp.append([b, h, w, cin, cout, kh])
        name = f"lowbit_conv_{mode}"
        kernels.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE,
            "replaces": CONV_REPLACES, "launches": launches.get(name, 0),
            "max_abs_err": check.max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if "operations" in by else "bytes",
            "library_ms": lib_ms, "device_ms": device_ms or None, "shapes_bhwcok": shp})

    log(f"[times] per kernel: ms = sum over the main path's calls of that kernel "
        f"(GeMM: one request per GEMM_GRID diagonal shape; conv: one batch of "
        f"{BATCH}), CUDA events around back-to-back wrapper calls; device_ms = the "
        f"kernels' own device time from torch.profiler; bound at max SM clock "
        f"{max_sm_mhz:.0f} MHz; total run {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
