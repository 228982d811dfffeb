"""Quickstart: the paper's low-bit matmul as a library.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Twin of ``examples/quickstart.py``: the three multiplications of the
paper (TNN / TBN / BNN), the typed packed-weight deployment path
(Algorithm 2: pack B once, offline, into a QTensor; serve with one fused
``ops.qmm`` call), the kernel registry, a tuned plan, and the overflow
guard of eq. (4).  ``--device`` defaults to ``cuda`` (the Hopper
kernels); ``cpu`` runs their plain versions.  ``main`` returns what it
checked.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import torch

from repro_torch import obs
from repro_torch.core import encoding, quantize
from repro_torch.core.qlinear import QuantLinear
from repro_torch.kernels import ops, registry
from repro_torch.kernels.modes import QuantMode, resolve_device
from repro_torch.kernels.qtensor import QTensor
from repro_torch.kernels.ref import matmul_f32_ref


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out: Dict[str, Any] = {}

    # --- 1. ternary x ternary (TNN), float-in/float-out with STE grads ------
    x = torch.randn((32, 256), generator=gen, device=dev)
    w = torch.randn((256, 64), generator=gen, device=dev)
    y_tnn = ops.quantized_matmul(x, w, QuantMode.TNN)
    print("TNN  out:", tuple(y_tnn.shape), y_tnn.dtype)

    # --- 2. the integer core directly (what the paper's Table III times) ----
    a = encoding.random_ternary(gen, (16, 512))       # values in {-1, 0, 1}
    b = encoding.random_binary(gen, (512, 8))         # values in {-1, 1}
    y_ref = matmul_f32_ref(a, b)                      # float reference
    y_tbn = ops.lowbit_matmul(a, b, QuantMode.TBN)
    out["tbn_exact"] = bool(torch.equal(y_tbn.to(torch.float32), y_ref))
    if not out["tbn_exact"]:
        raise AssertionError("TBN integer core differs from the float reference")
    print("TBN  integer core == float reference (exact)")

    # --- 3. packed weights: pack once offline into a QTensor, 16x smaller ---
    layer = QuantLinear(256, 64, mode=QuantMode.BNN)
    params = layer.init(gen, device=dev)
    packed = layer.pack(params)                       # paper Algorithm 2 PackedB
    print(f"BNN  packed container: {packed}")
    out["bnn_packed_bytes"] = packed.nbytes()
    print(f"BNN  packed weights: {packed.nbytes()} bytes "
          f"(vs {params['w'].numel() * params['w'].element_size()} fp32)")
    y = layer.apply_packed(packed, torch.randn((8, 256), generator=gen, device=dev))
    print("BNN  packed apply:", tuple(y.shape))

    # the same container + ops.qmm is the whole serving API: mode, depth and
    # scale ride inside the QTensor, only the backend is a call-site knob
    qt = QTensor.from_dense(w, QuantMode.TNN)
    y_direct = ops.qmm(x, qt)                         # one fused dispatch
    torch.testing.assert_close(y_direct, y_tnn, rtol=1e-5, atol=1e-5)
    out["qmm_equals_qat"] = True
    print("TNN  ops.qmm(x, QTensor) == QAT forward")

    # --- 4. the kernel registry: what can run, enumerated --------------------
    print("registered kernels (mode x backend x fused):")
    for spec in registry.available(fused=True):
        tun = "-" if spec.tunable is None else spec.tunable.kind
        print(f"  {spec.mode.value:4s} {spec.backend:7s} epilogue={spec.epilogue:10s} "
              f"compute={spec.compute:14s} tunable={tun}")

    # --- 4b. autotuning: per-shape tile search, plan cache -------------------
    # Tune this (m, n, k) problem once on the live device; ops.qmm then takes
    # the tuned tile from the plan cache.  `python -m repro_torch.tune` runs
    # the same search offline; REPRO_TUNE_CACHE moves the cache file.
    from repro_torch.tune import cache as plan_cache
    from repro_torch.tune import tuner

    x2 = torch.randn((48, 256), generator=gen, device=dev)
    plan, measured = tuner.ensure_plan(QuantMode.TNN, "cuda", fused=True, m=48, n=64, k=256,
                                       save=False, device=dev)
    print(f"tuned plan {plan.key}: {plan.tiles.to_json()} "
          f"({'measured' if measured else 'cache hit'})")
    y_tuned = ops.qmm(x2, qt)
    torch.testing.assert_close(y_tuned, ops.qmm(x2, qt, backend="dense"), rtol=1e-5,
                               atol=1e-5)
    print(f"tuned qmm == dense backend (tiling never changes numerics); cache: "
          f"{plan_cache.get_cache().path}")

    # --- 5. the paper's overflow guard, eq. (4)/(5) --------------------------
    kmax = quantize.k_max(1, 16, signed_unit=True)
    out["k_max_16"] = kmax
    print("k_max for 16-bit accumulation of ternary products:", kmax)
    print("max conv C_in for a 3x3 kernel:", quantize.max_conv_in_channels(kmax, 3, 3))

    # --- 6. telemetry: everything above was counted ---------------------------
    snap_path = obs.write_snapshot_if_configured()
    calls = obs.get_registry().get("repro_qmm_dispatch_total").total()
    print(f"obs: {calls:.0f} qmm dispatches counted"
          + (f"; snapshot -> {snap_path}" if snap_path else ""))
    return out


if __name__ == "__main__":
    main()
