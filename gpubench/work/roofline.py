"""The yardstick's work and peak arithmetic: one H100 SXM's published peaks
and the least work of each kernel and step the cells run, from shapes.

A frozen copy of what the port's ``repro_torch/roofline/analysis.py``
computes (``HW``, ``Work``, ``gemm_work``, ``conv_pack_work``,
``conv_work``, ``proj_shapes``, the prefill term of ``lm_bounds``), kept
here so that a change to the program cannot move the benchmark's
rooflines; ``gpubench/tests/test_bench_work.py`` holds the two equal at
every cell's shapes.  Configurations are plain dicts (the cell's config
file), not the program's config objects.

Rates: popcounts at 16 per clock per SM (CUDA programming guide, compute
capability 9.0) on 132 SMs at 1.98 GHz; float32 outside the tensor cores
67 TFLOP/s, bf16 989 TFLOP/s, int8 1,979 TOP/s, HBM 3.35 TB/s (NVIDIA's
H100 SXM data sheet, dense).  A bound is the larger of operations over
their class' peak (classes add) and bytes over the HBM rate, each input
byte read once and each output byte written once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["HW", "Work", "NPOPC", "gemm_work", "conv_pack_work", "conv_work",
           "conv_out_hw", "cnn_layers", "cnn_kernel_work", "cnn_step_work",
           "ssm_dims", "proj_shapes", "ssd_forward_flops", "prefill_kernel_work",
           "prefill_step_work", "train_kernel_work", "train_step_work", "bound_ms"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM's peak rates (data sheet; dense, no sparsity)."""
    fp32_flops: float = 67e12
    bf16_flops: float = 989e12
    int8_ops: float = 1.979e15
    sms: int = 132
    popc_per_clk_per_sm: int = 16
    sm_clock_hz: float = 1.98e9
    hbm_bw: float = 3.35e12

    @property
    def popc_per_s(self) -> float:
        return self.sms * self.popc_per_clk_per_sm * self.sm_clock_hz

    def peak(self, cls: str) -> float:
        return {"f32": self.fp32_flops, "bf16": self.bf16_flops,
                "int8": self.int8_ops, "popc": self.popc_per_s}[cls]


@dataclasses.dataclass
class Work:
    """Operations by class (``HW.peak``'s keys) and bytes moved."""
    ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for k, v in other.ops.items():
            ops[k] = ops.get(k, 0.0) + v
        return Work(ops, self.bytes + other.bytes)

    def compute_s(self, hw: HW = HW()) -> float:
        return sum(v / hw.peak(k) for k, v in self.ops.items())

    def memory_s(self, hw: HW = HW()) -> float:
        return self.bytes / hw.hbm_bw

    def bound(self, hw: HW = HW()) -> Tuple[float, str]:
        """(ms, "operations" | "bytes"): the least time and its term."""
        t_ops, t_bytes = self.compute_s(hw), self.memory_s(hw)
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bound_ms(works: List[Work], hw: HW = HW()) -> float:
    """Least time of kernels run one after another: the sum of each one's
    bound."""
    return sum(w.bound(hw)[0] for w in works)


# ---------------------------------------------------------------------------
# Per-kernel work (frozen from repro_torch.roofline.analysis)
# ---------------------------------------------------------------------------

NPOPC = {"tnn": 2, "tbn": 2, "bnn": 1}          # POPC per output per word
_PLANES = {"tnn": (2, 2), "tbn": (2, 1), "bnn": (1, 1)}   # (A planes, B planes)


def gemm_work(mode: str, m: int, n: int, kw: int, fused: bool = True) -> Work:
    """The popcount GeMM: A (m, kw) and B^T (n, kw) planes in, (m, n) out
    (float32 fused, with a row and a column scale)."""
    na, nb = _PLANES[mode]
    nbytes = 4 * kw * (m * na + n * nb) + 4 * m * n + (4 * (m + n) if fused else 0)
    return Work({"popc": float(m * n * kw * NPOPC[mode])}, float(nbytes))


def conv_pack_work(mode: str, b: int, h: int, w: int, c: int, hp: int, wp: int) -> Work:
    """The conv packing pass: float32 (b, h, w, c) in, one (BNN) or two
    (b, hp, wp, ceil(c / 32)) word planes out."""
    return Work({}, float(b * h * w * c * 4 + 4 * _PLANES[mode][0] * b * hp * wp * -(-c // 32)))


def conv_work(mode: str, b: int, hp: int, wp: int, cin: int, kh: int, kw: int,
              oh: int, ow: int, cout: int, words: int) -> Work:
    """The popcount conv on the packing pass' planes: packed input, weight
    planes and the column scale in, float32 (b * oh * ow, cout) out."""
    m = b * oh * ow
    na, nb = _PLANES[mode]
    nbytes = 4 * na * b * hp * wp * -(-cin // 32) + 4 * cout * words * nb + 4 * m * cout \
        + 4 * cout
    return Work({"popc": float(m * cout * words * NPOPC[mode])}, float(nbytes))


# ---------------------------------------------------------------------------
# The paper's CNN
# ---------------------------------------------------------------------------

def conv_out_hw(h: int, w: int, k: int, stride: int) -> Tuple[int, int, int, int]:
    """(OH, OW, padded H, padded W) of a SAME conv."""
    oh, ow = -(-h // stride), -(-w // stride)
    return oh, ow, h + max((oh - 1) * stride + k - h, 0), w + max((ow - 1) * stride + k - w, 0)


def cnn_layers(cfg: dict, batch: int):
    """Per conv layer: (mode, b, h, w, cin, k, stride, oh, ow, hp, wp, cout),
    the input map of each after the previous layer's pool."""
    out, h, c = [], cfg["img_size"], cfg["c_in"]
    for spec in cfg["convs"]:
        k, s = spec["kernel"], spec["stride"]
        oh, ow, hp, wp = conv_out_hw(h, h, k, s)
        out.append((spec["mode"], batch, h, h, c, k, s, oh, ow, hp, wp, spec["c_out"]))
        h, c = (oh // 2 if spec["pool"] else oh), spec["c_out"]
    return out


def cnn_kernel_work(cfg: dict, batch: int) -> List[Work]:
    """The packing pass and the popcount conv of every low-bit layer of one
    batch."""
    works = []
    for mode, b, h, w, cin, k, _, oh, ow, hp, wp, cout in cnn_layers(cfg, batch):
        if mode not in NPOPC:
            continue
        works.append(conv_pack_work(mode, b, h, w, cin, hp, wp))
        works.append(conv_work(mode, b, hp, wp, cin, k, k, oh, ow, cout,
                               k * k * -(-cin // 32)))
    return works


def cnn_step_work(cfg: dict, batch: int) -> Work:
    """The least work of one batch through the CNN: every low-bit conv's
    popcounts, the float first conv and classifier at float32 (their
    products are float32 ones), the images and weights read once, the
    logits written once."""
    ops = {"popc": 0.0, "f32": 0.0}
    weights = 0
    c_last = cfg["c_in"]
    for mode, b, _, _, cin, k, _, oh, ow, _, _, cout in cnn_layers(cfg, batch):
        m = b * oh * ow
        if mode in NPOPC:
            ops["popc"] += m * cout * k * k * -(-cin // 32) * NPOPC[mode]
            weights += cout * k * k * -(-cin // 32) * 4 * _PLANES[mode][1] + 4 * cout
        else:
            ops["f32"] += 2.0 * m * cout * k * k * cin
            weights += 4 * k * k * cin * cout
        c_last = cout
    ops["f32"] += 2.0 * batch * c_last * cfg["num_classes"]
    weights += 4 * c_last * cfg["num_classes"]
    img = cfg["img_size"]
    nbytes = 4 * batch * img * img * cfg["c_in"] + weights + 4 * batch * cfg["num_classes"]
    return Work(ops, float(nbytes))


# ---------------------------------------------------------------------------
# Mamba2 (the SSD mixer, no FFN): prefill and the QAT step
# ---------------------------------------------------------------------------

def ssm_dims(cfg: dict):
    """(d_inner, groups, state, head dim, heads, in_proj width)."""
    din = cfg["ssm_expand"] * cfg["d_model"]
    g, n, p = cfg["ssm_ngroups"], cfg["ssm_state"], cfg["ssm_headdim"]
    h = din // p
    return din, g, n, p, h, 2 * din + 2 * g * n + h


def proj_shapes(cfg: dict, m: int) -> List[Tuple[int, int, int]]:
    """(m, n, k) of every projection of one forward at ``m`` token rows:
    per layer ``in_proj`` and ``out_proj``."""
    din, _, _, _, _, width = ssm_dims(cfg)
    return [(m, width, cfg["d_model"]), (m, cfg["d_model"], din)] * cfg["num_layers"]


def ssd_forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """Float operations of one forward's chunked SSD scan: per chunk and
    group C B^T, per head the intra-chunk mix, the chunk states and the
    inter-chunk term (the products ``train_step_flops`` counts)."""
    din, g, n, p, h, _ = ssm_dims(cfg)
    q = min(cfg["ssm_chunk"], seq)
    chunks = batch * (seq // q)
    per_layer = chunks * (2 * h * q * q * p + 4 * q * h * n * p) + chunks * 2 * g * q * q * n
    return float(per_layer * cfg["num_layers"])


def prefill_kernel_work(cfg: dict, batch: int, seq: int) -> List[Work]:
    """The fused TNN GeMM of every projection of one prefill."""
    return [gemm_work("tnn", m, n, -(-k // 32)) for m, n, k in proj_shapes(cfg, batch * seq)]


def prefill_step_work(cfg: dict, batch: int, seq: int) -> Work:
    """The least work of one prefill forward: the projections' popcounts,
    the SSD scan's float32 products, the head's bf16 products at the last
    position; the packed weights, the embedding rows of the prompt and
    the head's table read once, the last logits written once."""
    m = batch * seq
    popc = sum(m_ * n * -(-k // 32) * NPOPC["tnn"] for m_, n, k in proj_shapes(cfg, m))
    d, v = cfg["d_model"], cfg["vocab_size"]
    planes = sum(2 * 4 * n * -(-k // 32) + 4 * n for _, n, k in proj_shapes(cfg, 1))
    nbytes = planes + 2 * m * d + 2 * d * v + 4 * batch * v + 8 * m
    return Work({"popc": float(popc), "f32": ssd_forward_flops(cfg, batch, seq),
                 "bf16": 2.0 * batch * d * v}, float(nbytes))


def train_kernel_work(cfg: dict, batch: int, seq: int, remat: bool) -> List[Work]:
    """The fused TNN GeMMs of one QAT step: each projection's forward, and
    again in the backward's recompute under remat."""
    return prefill_kernel_work(cfg, batch, seq) * (2 if remat else 1)


def train_step_work(cfg: dict, batch: int, seq: int, n_params: int) -> Work:
    """The least work of one QAT step: the projections' popcounts once
    (the forward), their straight-through backward's two float32 products
    (4 m n k), the SSD scan's products three times (forward and the two
    backward products of each), the head's forward and backward at bf16
    (6 m d V); the float32 masters, gradients and both moments read and
    the masters and moments written once, the tokens read once."""
    m = batch * seq
    shapes = proj_shapes(cfg, m)
    popc = sum(m_ * n * -(-k // 32) * NPOPC["tnn"] for m_, n, k in shapes)
    f32 = sum(4.0 * m_ * n * k for m_, n, k in shapes) + 3 * ssd_forward_flops(cfg, batch, seq)
    bf16 = 6.0 * m * cfg["d_model"] * cfg["vocab_size"]
    nbytes = 4 * n_params * (4 + 3) + 16 * m
    return Work({"popc": float(popc), "f32": f32, "bf16": bf16}, float(nbytes))
