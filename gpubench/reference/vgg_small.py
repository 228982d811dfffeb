"""Plain PyTorch reference of a low-bit CNN configuration (VGG-Small with
ternary convs, ``configs/vgg_small.json``), and the benchmark's weights
and images for it.

Imports nothing of the program.  Every conv is a SAME conv written as an
explicit im2col (``F.unfold``) and one matrix product, over blocks of
images so that the im2col matrix of a large batch fits: the float layers
(``f32`` / ``bf16`` modes: the first conv, kept in high precision as QNN
practice does) on float values, the low-bit ones on values re-derived
here from the same float inputs:

* weights per output channel: TNN by the TWN rule (threshold 0.7 mean|w|,
  scale the mean |w| above it), TBN / BNN by sign (0 counts as +1) with
  scale mean|w|;
* activations per tensor, over the whole im2col matrix of the batch
  (zero padding included; a first pass over the blocks): TNN / TBN
  ternary by the TWN rule, BNN by sign with scale mean|a|; a value that
  many activations share and that lies at the threshold to rounding goes
  either way (:data:`TIE_BAND`), and :func:`conv` gives both outputs;
* the integer product of the +-1/0 values, exact in float32, times the
  activation scale times the channel scale (eq. (2)).

ReLU after each conv and 2x2 max-pool where the config says ``pool``
(:func:`glue`), the spatial mean and the float classifier (:func:`head`).
``dtype`` is the precision of every float value and product (float32 as
the configuration states; bfloat16 is the control); the integer product
is exact in float32 either way, and the epilogue takes it in ``dtype``.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.lowbit import sub_seed

__all__ = ["sub_seed", "make_weights", "make_images", "conv", "glue", "head"]

LOWBIT = ("tnn", "tbn", "bnn")
# floats in one block's im2col matrix
BLOCK = 2 ** 27
# A conv's output takes discrete values (an integer times two scales), so
# after ReLU and pooling many activations can share one value.  Where such
# a value lies within TIE_BAND of the ternary threshold, the last bit of
# the threshold's sum decides all of them at once, and either way is sound.
TIE_BAND = 1e-5
TIE_COUNT = 256


def make_weights(cfg: dict, seed: int, device) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Float32 filters (kh, kw, cin, cout), one draw a layer, scaled by
    (kh kw cin)^-0.5, and the (c_last, classes) classifier scaled by
    c_last^-0.5, on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    filters, c_in = [], cfg["c_in"]
    for spec in cfg["convs"]:
        k = spec["kernel"]
        w = torch.randn((k, k, c_in, spec["c_out"]), generator=g, device=device)
        filters.append(w * (k * k * c_in) ** -0.5)
        c_in = spec["c_out"]
    cls = torch.randn((c_in, cfg["num_classes"]), generator=g, device=device)
    return filters, cls * c_in ** -0.5


def make_images(cfg: dict, seed: int, count: int, batch: int, device) -> torch.Tensor:
    """(count, batch, H, W, C) float32 N(0, 1) images on ``device``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    s = cfg["img_size"]
    return torch.randn((count, batch, s, s, cfg["c_in"]), generator=g, device=device)


def _im2col(x: torch.Tensor, k: int, stride: int):
    """(B, H, W, C) -> ((B*OH*OW, C*k*k), (B, OH, OW)), SAME zero padding
    (an odd total's extra row and column at the bottom and right)."""
    b, h, w, _ = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph, pw = max((oh - 1) * stride + k - h, 0), max((ow - 1) * stride + k - w, 0)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    cols = F.unfold(xp, k, stride=stride)               # (B, C*k*k, OH*OW)
    return cols.transpose(1, 2).reshape(b * oh * ow, -1), (b, oh, ow)


def _blocks(x: torch.Tensor, k: int, stride: int) -> Iterator[torch.Tensor]:
    """The im2col matrix of ``x`` in blocks of whole images."""
    per_image = -(-x.shape[1] // stride) * -(-x.shape[2] // stride) * x.shape[3] * k * k
    step = max(1, BLOCK // per_image)
    for i in range(0, x.shape[0], step):
        yield _im2col(x[i:i + step], k, stride)[0]


def _act_mean(x: torch.Tensor, spec: dict) -> torch.Tensor:
    """mean |a| over the whole im2col matrix of ``x``."""
    total = count = 0.0
    for a in _blocks(x, spec["kernel"], spec["stride"]):
        total += float(a.abs().sum(dtype=torch.float64))
        count += a.numel()
    return torch.tensor(total / count, dtype=x.dtype, device=x.device)


def _thresholds(x: torch.Tensor, spec: dict, thr: torch.Tensor) -> List[torch.Tensor]:
    """The ternary threshold ``thr``, and where a value that ``TIE_COUNT`` or
    more im2col entries share lies within ``TIE_BAND`` of it, that value
    counted below and above the threshold."""
    counts = {}
    for a in _blocks(x, spec["kernel"], spec["stride"]):
        v = a.abs()
        near = v[(v - thr).abs() <= TIE_BAND * thr]
        for value, n in zip(*(t.tolist() for t in torch.unique(near, return_counts=True))):
            counts[value] = counts.get(value, 0) + n
    out = [thr]
    for value, n in counts.items():
        if n >= TIE_COUNT:
            level = torch.tensor(value, dtype=x.dtype, device=x.device)
            out += [level, torch.nextafter(level, torch.zeros_like(level))]
    return out


def _act_scale(x: torch.Tensor, spec: dict, thr: torch.Tensor) -> torch.Tensor:
    """The mean |a| above ``thr`` over the whole im2col matrix of ``x``."""
    above = kept = 0.0
    for a in _blocks(x, spec["kernel"], spec["stride"]):
        mask = a.abs() > thr
        above += float((a.abs() * mask).sum(dtype=torch.float64))
        kept += float(mask.sum())
    return torch.tensor(above / max(kept, 1.0), dtype=x.dtype, device=x.device)


def _weights(wm: torch.Tensor, mode: str):
    """Per output column: (+-1/0 values, scale)."""
    a = wm.abs()
    mean = a.mean(dim=0, keepdim=True)
    if mode != "tnn":
        return torch.where(wm < 0, -1.0, 1.0).to(wm.dtype), mean
    mask = a > 0.7 * mean
    scale = (a * mask).sum(dim=0, keepdim=True) / mask.sum(dim=0, keepdim=True).clamp(min=1)
    return torch.sign(wm) * mask, scale


def conv(spec: dict, w: torch.Tensor, x: torch.Tensor, dtype=torch.float32
         ) -> List[torch.Tensor]:
    """One conv of ``spec`` with float32 filters ``w`` (k, k, cin, cout) on
    its input ``x`` (B, H, W, cin) -> its (B, OH, OW, cout) output in
    ``dtype``, before its ReLU: one, or for a ternary threshold with a
    tie at it (:func:`_thresholds`) one for each way the tie can go."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        k, s, cout = spec["kernel"], spec["stride"], spec["c_out"]
        x = x.to(dtype)
        wm = w.permute(2, 0, 1, 3).reshape(-1, cout).to(dtype)        # rows (c, dy, dx)
        oh, ow = -(-x.shape[1] // s), -(-x.shape[2] // s)
        if spec["mode"] not in LOWBIT:
            return [torch.cat([a @ wm for a in _blocks(x, k, s)]).reshape(x.shape[0], oh, ow,
                                                                          cout)]
        wt, sw = _weights(wm, "tnn" if spec["mode"] == "tnn" else "bnn")
        wt = wt.to(torch.float32)
        mean = _act_mean(x, spec)
        if spec["mode"] == "bnn":
            acts = [(None, mean)]
        else:
            acts = [(t, _act_scale(x, spec, t)) for t in _thresholds(x, spec, 0.7 * mean)]
        outs = []
        for thr, sa in acts:
            out = []
            for a in _blocks(x, k, s):
                at = torch.where(a < 0, -1.0, 1.0) if thr is None \
                    else torch.sign(a) * (a.abs() > thr)
                acc = at.to(torch.float32) @ wt
                out.append((acc.to(dtype) * sa) * sw)
            outs.append(torch.cat(out).reshape(x.shape[0], oh, ow, cout))
        return outs
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def glue(spec: dict, y: torch.Tensor) -> torch.Tensor:
    """A conv's output -> the next conv's input: ReLU, then the 2x2
    max-pool where ``spec`` says."""
    h = torch.relu(y)
    if spec["pool"]:
        b, oh, ow, c = h.shape
        h = h.reshape(b, oh // 2, 2, ow // 2, 2, c).amax(dim=(2, 4))
    return h


def head(spec: dict, y: torch.Tensor, classifier: torch.Tensor,
         dtype=torch.float32) -> torch.Tensor:
    """The last conv's output -> (B, classes) float32 logits: its glue, the
    spatial mean, the classifier, in ``dtype``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h = glue(spec, y.to(dtype))
        return (h.mean(dim=(1, 2)) @ classifier.to(dtype)).to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
