"""Roofline terms of the port on an NVIDIA H100 SXM, and the work each
kernel of ``csrc/`` does on a problem.

Counterpart of ``repro/roofline/analysis.py``, over the port's dry-run
records (``launch/dryrun.py``) in place of compiled XLA artifacts:

    compute    = sum over classes of work (ops of the class / its peak)
    memory     = bytes accessed / HBM rate
    collective = sum over mesh axes of (collective bytes / the axis' link rate)

and the step time is the largest of the three (overlapped execution), as
in the reference.  Unlike the reference's one bf16 peak, each class of
work runs at its own rate and the class times add: float32 products
outside the tensor cores, bf16 (and fp16) on the tensor cores, int8
tensor-core operations (the dense and u8/u4 kernels: 2 m n k) and
popcounts (the popcount kernels: ``NPOPC`` per output per 32-bit word).

:class:`HW` holds the H100 SXM data sheet's rates in place of the TPU v5e
constants of the reference; the popcount rate is the CUDA programming
guide's 16 per clock per SM (compute capability 9.0) on 132 SMs at the SM
clock.  A card run reads its maximum SM clock from ``nvidia-smi`` and
passes it as ``HW(sm_clock_hz=...)``.

The work functions (:func:`gemm_work`, :func:`dense_gemm_work`,
:func:`affine_gemm_work`, :func:`conv_pack_work`, :func:`conv_stats_work`,
:func:`conv_work`, :func:`conv_fused_work`, and :func:`kernel_work` over a
``_build.record`` entry) take a kernel's problem dims and return its
:class:`Work`: operations by class and the bytes the kernel must move
(each input read once, each output written once).  ``chip_smoke.py``'s
bound columns and the dry-run's kernel terms both come from them; so do
:func:`lm_bounds` (an LM run's decode and prefill bounds),
:func:`train_step_flops` (the float products of one QAT step, on one
device or one rank of a tensor-parallel mesh) and
:func:`train_mesh_collectives` (a training-mesh step's collectives per
rank, from its shardings: the port's mesh code, imported when called).

The module imports nothing at load time, so a script can load it from
its file to bound another checkout's kernels with this checkout's
formulas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["HW", "Work", "RooflineTerms", "model_flops", "roofline_from_artifact",
           "NPOPC", "gemm_work", "dense_gemm_work", "affine_gemm_work", "conv_pack_work",
           "conv_stats_work", "conv_work", "conv_fused_work", "kernel_work", "proj_shapes",
           "kv_bytes_per_token", "lm_bounds", "train_step_flops", "train_mesh_collectives",
           "DTYPE_CLASS"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM's peak rates (data sheet; dense, no sparsity)."""
    fp32_flops: float = 67e12        # float32 outside the tensor cores
    bf16_flops: float = 989e12       # bf16 / fp16 tensor cores
    int8_ops: float = 1.979e15       # int8 tensor cores
    sms: int = 132
    popc_per_clk_per_sm: int = 16    # CUDA programming guide, compute capability 9.0
    sm_clock_hz: float = 1.98e9      # the card's maximum SM clock
    hbm_bw: float = 3.35e12          # bytes/s
    nvlink_bw: float = 450e9         # NVLink 4, bytes/s per direction per GPU
    ib_bw: float = 50e9              # InfiniBand NDR (400 Gb/s) per GPU: the "pod" axis

    @property
    def popc_per_s(self) -> float:
        return self.sms * self.popc_per_clk_per_sm * self.sm_clock_hz

    def peak(self, cls: str) -> float:
        """Operations per second of one class of work."""
        return {"f32": self.fp32_flops, "bf16": self.bf16_flops,
                "int8": self.int8_ops, "popc": self.popc_per_s}[cls]

    def link_bw(self, axis: str) -> float:
        """Bytes/s per GPU of a collective over mesh ``axis``."""
        return self.ib_bw if axis == "pod" else self.nvlink_bw


# torch dtype name -> the class of work its products run in (any other
# dtype counts as float32)
DTYPE_CLASS = {"float32": "f32", "bfloat16": "bf16", "float16": "bf16", "int8": "int8",
               "uint8": "int8"}


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

    def compute_s(self, hw: Optional[HW] = None) -> float:
        hw = hw or HW()
        return sum(v / hw.peak(k) for k, v in self.ops.items())

    def memory_s(self, hw: Optional[HW] = None) -> float:
        return self.bytes / (hw or HW()).hbm_bw

    def bound(self, hw: Optional[HW] = None) -> Tuple[float, str]:
        """(ms, "operations" | "bytes"): the least time for this work, and
        which term sets it."""
        t_ops, t_bytes = self.compute_s(hw), self.memory_s(hw)
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# Per-kernel work
# ---------------------------------------------------------------------------

NPOPC = {"tnn": 2, "tbn": 2, "bnn": 1}       # POPC per output per word
_PLANES = {"tnn": (2, 2), "tbn": (2, 1), "bnn": (1, 1)}   # (A planes, B planes)


def _gemm_bytes(mode: str, m: int, n: int, kw: int, fused: bool) -> float:
    na, nb = _PLANES[mode]
    return 4 * kw * (m * na + n * nb) + 4 * m * n + (4 * (m + n) if fused else 0)


def gemm_work(mode: str, m: int, n: int, kw: int, k: int = 0, fused: bool = True) -> Work:
    """The popcount GeMM (``lowbit_gemm_<mode>_{fused,i32}``): A (m, kw) and
    B^T (n, kw) planes in, (m, n) out (float32 fused, with a row and a
    column scale; int32 core)."""
    return Work({"popc": float(m * n * kw * NPOPC[mode])}, _gemm_bytes(mode, m, n, kw, fused))


def dense_gemm_work(mode: str, m: int, n: int, kw: int, k: int) -> Work:
    """The tensor-core GeMM (``dense_gemm_<mode>``): 2 m n k int8
    operations on the same operands as the fused popcount GeMM."""
    return Work({"int8": 2.0 * m * n * k}, _gemm_bytes(mode, m, n, kw, True))


def affine_gemm_work(m: int, n: int, k: int, u4: bool = False) -> Work:
    """The u8 / u4 GeMM (``affine_gemm_{u8,u4}``): (m, k) and (k, n) bytes
    (nibble-packed along k for u4) in, int32 (m, n) out."""
    kb = -(-k // 2) if u4 else k
    return Work({"int8": 2.0 * m * n * k}, float(m * kb + kb * n + 4 * m * n))


def conv_pack_work(mode: str, b: int, h: int, w: int, c: int, hp: int, wp: int) -> Work:
    """The conv packing pass (``conv_pack_<mode>``): float32 (b, h, w, c)
    in, one (BNN) or two (b, hp, wp, ceil(c / 32)) word planes out."""
    return Work({}, float(b * h * w * c * 4 + 4 * _PLANES[mode][0] * b * hp * wp * -(-c // 32)))


def conv_stats_work(mode: str, b: int, h: int, w: int, c: int) -> Work:
    """The conv activation statistics (``conv_stats_<mode>``): one read of
    the float32 (b, h, w, c) input a pass, two for TNN/TBN (the masked sums
    need the threshold first), one for BNN; three scalars out."""
    return Work({}, float((1 if mode == "bnn" else 2) * 4 * b * h * w * c))


def conv_work(mode: str, b: int, hp: int, wp: int, cin: int, kh: int, kw: int,
              stride: int, oh: int, ow: int, cout: int, words: int,
              dense: bool = False) -> Work:
    """The conv kernel alone (``lowbit_conv_<mode>``, ``dense_conv_<mode>``)
    on the packing pass' planes: packed input, weight planes and the
    column scale in, float32 (b * oh * ow, cout) out."""
    m = b * oh * ow
    na, nb = _PLANES[mode]
    nbytes = 4 * na * b * hp * wp * -(-cin // 32) + 4 * cout * words * nb + 4 * m * cout \
        + 4 * cout
    ops = {"int8": 2.0 * m * cout * kh * kw * cin} if dense else \
        {"popc": float(m * cout * words * NPOPC[mode])}
    return Work(ops, float(nbytes))


def conv_fused_work(mode: str, b: int, h: int, w: int, cin: int, kh: int, kw: int,
                    oh: int, ow: int, cout: int, words: int, dense: bool = False) -> Work:
    """A conv wrapper's call as one pass (pack + conv, the bound of
    ``chip_smoke.py``'s conv rows): float32 input, weight planes (and,
    dense, the column scale) in, float32 (b * oh * ow, cout) out."""
    m = b * oh * ow
    nbytes = b * h * w * cin * 4 + 4 * cout * words * _PLANES[mode][1] + 4 * m * cout
    if dense:
        return Work({"int8": 2.0 * m * cout * kh * kw * cin}, float(nbytes + 4 * cout))
    return Work({"popc": float(m * cout * words * NPOPC[mode])}, float(nbytes))


def kernel_work(key: str, problem: Dict[str, int]) -> Work:
    """The :class:`Work` of one kernel recorded on ``meta``
    (``kernels._build.record``: its launch key and problem)."""
    p = problem
    if key.startswith("lowbit_gemm_"):
        mode, variant = key[len("lowbit_gemm_"):].split("_")
        return gemm_work(mode, p["m"], p["n"], p["kw"], p["k"], variant == "fused")
    if key.startswith("dense_gemm_"):
        return dense_gemm_work(key[len("dense_gemm_"):], p["m"], p["n"], p["kw"], p["k"])
    if key.startswith("affine_gemm_"):
        return affine_gemm_work(p["m"], p["n"], p["k"], key.endswith("u4"))
    if key.startswith("conv_pack_"):
        return conv_pack_work(key[len("conv_pack_"):], p["b"], p["h"], p["w"], p["c"],
                              p["hp"], p["wp"])
    if key.startswith("conv_stats_"):
        return conv_stats_work(key[len("conv_stats_"):], p["b"], p["h"], p["w"], p["c"])
    for prefix, dense in (("lowbit_conv_", False), ("dense_conv_", True)):
        if key.startswith(prefix):
            return conv_work(key[len(prefix):], p["b"], p["hp"], p["wp"], p["cin"], p["kh"],
                             p["kw"], p["stride"], p["oh"], p["ow"], p["cout"], p["words"],
                             dense)
    raise KeyError(f"no work function for kernel {key!r}")


# ---------------------------------------------------------------------------
# LM runs from shapes
# ---------------------------------------------------------------------------

def proj_shapes(cfg, m: int, m_expert: int):
    """(m, n, k) of every projection of one forward of ``cfg`` at ``m``
    token rows (``m_expert`` rows per MoE expert)."""
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


def kv_bytes_per_token(cfg, kv: str) -> int:
    """Cache bytes one token occupies in one attention layer: K and V and
    its position (bf16 slab: 2 bytes a value; tnn2: two bit planes of
    ceil(dh / 32) words a head and a float32 scale, for K and for V)."""
    dh, kvh = cfg.head_dim_, cfg.num_kv_heads
    if kv == "tnn2":
        return 2 * (kvh * 2 * -(-dh // 32) * 4 + 4) + 4
    return 2 * kvh * dh * 2 + 4


def lm_bounds(cfg, batch: int, prompt: int, steps: int, packed_bytes: int,
              kv: str = "bf16", hw: Optional[HW] = None) -> Tuple[float, float]:
    """Least times of an LM run, from shapes: a decode step moves at least
    the packed projections, the bf16 LM head and its cache (the KV cache
    at its longest, or the SSM states read and written); the prefill's
    popcount GeMMs do at least :func:`gemm_work`'s popcounts (``tnn``)
    over every projection.  Returns (decode ms, prefill GeMM ms)."""
    from repro_torch.models.moe import moe_capacity

    hw = hw or HW()
    attn = sum(m in ("A", "AL") for m, _ in cfg.layer_pattern) * cfg.num_periods
    ssm = sum(m == "M" for m, _ in cfg.layer_pattern) * cfg.num_periods
    cache = attn * batch * (prompt + steps) * kv_bytes_per_token(cfg, kv)
    if ssm:
        din, g, n = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
        state = cfg.ssm_nheads * n * cfg.ssm_headdim + (cfg.ssm_conv - 1) * (din + 2 * g * n)
        cache += 2 * ssm * batch * state * 4
    decode = Work({}, float(packed_bytes + cfg.d_model * cfg.vocab_size * 2 + cache))
    m_exp = batch * moe_capacity(cfg, prompt) if cfg.num_experts else 0
    popc = sum(m * n * -(-k // 32) * NPOPC["tnn"]
               for m, n, k in proj_shapes(cfg, batch * prompt, m_exp))
    return decode.memory_s(hw) * 1e3, Work({"popc": float(popc)}).compute_s(hw) * 1e3


def _ssm_tp_dims(cfg, tp: int):
    """(d_inner, groups, heads) one rank of ``tp`` computes with
    (``models.ssm._tp_dims``): its heads, and its groups when they split,
    else the one group its heads lie in."""
    g, h = cfg.ssm_ngroups, cfg.ssm_nheads
    return cfg.ssm_d_inner // tp, g // tp if g % tp == 0 else 1, h // tp


def train_step_flops(cfg, batch: int, seq: int, tp: int = 1) -> float:
    """Float operations of one QAT step of ``cfg`` at (batch, seq), from
    shapes: per projection the STE backward's two products (gx, gw: 4 m n
    k; the forward is the popcount GeMM; an MoE expert's m its slots,
    ``batch * moe_capacity``), the head forward and backward (6 m d V),
    per attention layer and sequence QK^T and PV (4 S^2 d) in the forward,
    the remat recompute and twice in the backward (16 S^2 d), and the
    same four passes (forward, recompute, two backward products) of the
    MoE router (2 m d E) and of the chunked SSD scan's four float products
    per chunk (C B^T per group, the intra-chunk mix, the chunk states and
    the inter-chunk term per head).  ``tp``: one rank of a
    tensor-parallel step (``TRAIN_RULES``) over ``batch`` of its rows,
    which splits every product's heads, FFN, vocab, sequence (the
    router) or SSM heads ``tp`` ways (heads the axis divides: no padding
    heads) but for what each rank repeats: the B and C columns of
    ``in_proj`` and C B^T of the groups its heads lie in when the groups
    do not split."""
    from repro_torch.models.moe import moe_capacity

    m = batch * seq
    m_exp = batch * moe_capacity(cfg, seq) if cfg.num_experts else 0
    split = sum(4 * mm * n * k for mm, n, k in proj_shapes(cfg, m, m_exp))
    split += 6 * m * cfg.d_model * cfg.vocab_size
    din, g, n, h, p = (cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                       cfg.ssm_headdim)
    q = min(cfg.ssm_chunk, seq)
    chunks = batch * (seq // q) if cfg.ssm_state else 0
    _, gl, _ = _ssm_tp_dims(cfg, tp)
    # one forward's float products of each block kind, split and repeated
    fwd = {"A": 4 * batch * seq * seq * cfg.num_heads * cfg.head_dim_,
           "M": chunks * (2 * h * q * q * p + 4 * q * h * n * p),
           "E": 2 * m * cfg.d_model * cfg.num_experts}
    cb = chunks * 2 * g * q * q * n
    bc = 4 * m * cfg.d_model * 2 * g * n      # in_proj's B and C columns (in proj_shapes)
    repeated = 0.0
    # with remat_block every block but a period's last runs a third forward
    nested = cfg.remat and cfg.remat_block and cfg.period > 1
    for i, (mixer, ffn_kind) in enumerate(cfg.layer_pattern):
        runs = 4 + (nested and i < cfg.period - 1)
        kinds = ["A" if mixer in ("A", "AL") else mixer] + (["E"] if ffn_kind == "E" else [])
        for kind in kinds:
            split += cfg.num_periods * runs * fwd.get(kind, 0)
        if mixer == "M":
            split -= cfg.num_periods * bc
            repeated += cfg.num_periods * (bc + runs * cb)
    return split / tp + repeated * gl / g


# all-reduces of one quantized projection's statistics: the activations'
# (a sum, then the kept sum; the affine range: one max) and a row-parallel
# weight's per channel (the affine grid: one max)
_ACT_STAT_REDUCES = {"tnn": 2, "tbn": 2, "bnn": 1, "int8": 1, "int4": 1}
_W_STAT_REDUCES = {"tnn": 2, "tbn": 1, "bnn": 1, "int8": 1, "int4": 1}
# and a column-parallel weight split over "model": the affine grid spans
# the whole weight (a per-channel one is the chunk's own)
_COL_W_STAT_REDUCES = {"int8": 1, "int4": 1}


def _block_collectives(cfg, mixer: str, ffn_kind: str, split, sp: bool, policy: str,
                       nb: int, nbt: int) -> Dict[str, int]:
    """One block's collectives per microbatch on the training mesh:
    ``fwd_*`` those of one forward (twice under remat), ``bwd_*`` those of
    the backward, by kind (``ag``, ``rs``, ``ar``), and ``tail``: the kind
    of a float row-parallel reduction that ends the block (a separate op
    after its product, which the remat recompute stops short of), or None.
    ``nb`` / ``nbt``: the batch axes of size > 1, and with the
    tensor-parallel axis."""
    act = _ACT_STAT_REDUCES.get(policy, 0)
    w_st = _W_STAT_REDUCES.get(policy, 0)
    col_w = _COL_W_STAT_REDUCES.get(policy, 0)
    c = {f"{ph}_{k}": 0 for ph in ("fwd", "bwd") for k in ("ag", "rs", "ar")}
    c["tail"] = None

    def dense(n_proj, n_col, tp_on, col_split=True):
        # n_proj projections: n_col column-parallel sharing one entered
        # input (their weights split over "model" unless the rank holds
        # them whole: Mamba2's in_proj), one row-parallel back into the
        # residual stream
        if not tp_on:
            c["fwd_ar"] += act * nb * n_proj
            return
        c["fwd_ar"] += act * nb * n_col + act * nbt + w_st + col_w * n_col * col_split
        if sp:
            c["fwd_ag"] += 1
            c["fwd_rs"] += 1
            c["bwd_rs"] += 1
            c["bwd_ag"] += 1
        else:
            c["fwd_ar"] += 1
            c["bwd_ar"] += 1
        c["tail"] = ("rs" if sp else "ar") if act == 0 else None

    if mixer in ("A", "AL"):
        dense(4, 3, "heads" in split)
    elif mixer == "M":
        dense(2, 1, "ssm_heads" in split, col_split=False)
        if "ssm_heads" in split:              # the gated norm's sum of squares
            c["fwd_ar"] += 1
            c["bwd_ar"] += 1
    if ffn_kind == "D":
        dense(3, 2, "ffn" in split)
    elif ffn_kind == "E":
        shared = 1 if cfg.shared_expert_d_ff else 0
        if "ffn" in split:
            # every expert's and the shared expert's statistics stacked: the
            # column-parallel inputs over the batch axes, the row-parallel
            # ones over the batch axes and the tensor-parallel axis, the
            # down weights' (and an affine grid's gates and ups) over the
            # latter; their int32 counts in one all-reduce; the router's
            # probabilities and the tokens gathered, the combine's shard
            # taken
            c["fwd_ar"] += act * nb + act * nbt + w_st + col_w + 1
            if sp:
                c["fwd_ag"] += 2
                c["bwd_rs"] += 1
                c["bwd_ag"] += 1
            else:
                c["bwd_ar"] += 1
        else:
            c["fwd_ar"] += act * nb * 3 * (cfg.num_experts + shared)
        c["fwd_ar"] += 3 * nb                  # the aux loss's counts over the batch
        c["tail"] = None
    return c


def train_mesh_collectives(cfg, tcfg, shardings, mesh, policy: str, seq: int) -> Dict[str, int]:
    """The training mesh's collectives per rank per step of ``cfg`` on
    ``mesh`` under the active rules, each counted once per mesh axis of
    size > 1 it runs over, as ``launch.mesh.collectives`` counts them;
    predicted from the train state's ``shardings`` and the rules:

    * every leaf by its plan (``sharding.leaf_plans``, or ``whole_plans``
      off a tensor-parallel split): per microbatch a gather per axis it
      is gathered over, its gradient reduce-scattered over those of its
      sum axes and all-reduced over the others; a leaf gathered over none
      all-reduces its gradient over its sum axes once;
    * an int8 moment whose shard cuts a 256-block: its block maxima
      (all-reduce) and its scales (gather), for m and v;
    * per block and microbatch (:func:`_block_collectives`), per forward
      (twice under remat): each quantized projection's activation
      statistics over the batch axes (and the tensor-parallel axis for a
      row-parallel one) and a row-parallel weight's channel statistics
      over the tensor-parallel axis (an MoE layer's experts stacked: one
      collective per round); under int8 / int4 one max for an activation
      range and one for each weight's grid, column-parallel ones too (but
      a weight the rank holds whole); tensor parallelism's boundaries: each split
      region's input gathered (sequence parallelism) in the forward and
      its backward's reduce-scatter, each row-parallel output's
      reduce-scatter in the forward and its backward's gather (without
      sequence parallelism all-reduces in their place: the input's
      backward, the output's forward); the Mamba2 norm's sum of squares
      (forward and backward); an MoE layer's gathered router
      probabilities, its experts' counts in one all-reduce, the combine's
      shard (backward gather) and its aux loss's three sums over the
      batch.  The recompute stops after the last op whose saved tensors
      the backward needs, so under a float policy it skips the last
      row-parallel reduction of what it recomputes (a period, or with
      ``remat_block`` each block) when one ends it;
    * the vocab-parallel embedding's and the head input's pair, the
      loss's row max and its sums over the vocab, per chunk;
    * the loss's token count per microbatch, the loss shares, the global
      norm and EF's absmax (one each over the whole mesh)."""
    from repro_torch.optim.adamw import Q8Layout
    from repro_torch.parallel import sharding
    from repro_torch.tree import flatten_with_paths

    def n(axes):
        return sum(1 for a in axes if mesh.axis_size(a) > 1)

    ctx = sharding.active()
    batch = [a for a in sharding.batch_axes(ctx) if mesh.axis_size(a) > 1]
    tp = sharding.tp_axis(ctx)
    sp = tp is not None and sharding.seq_parallel(ctx, tp) and seq % mesh.axis_size(tp) == 0
    if tp is None:
        plans, split = sharding.whole_plans(shardings["params"], ctx), frozenset()
    else:
        plans, split = sharding.leaf_plans(shardings["params"], ctx, sp=sp)
    plan_of = dict(flatten_with_paths(plans))
    opt_m = dict(flatten_with_paths(shardings["opt"]["m"]))
    micro = tcfg.microbatch
    gathers = scatters = reduces = 0
    for path, p in flatten_with_paths(shardings["params"]):
        plan = plan_of[path]
        axes = {a for e in plan.gather for a in sharding.spec_axes(e)}
        if plan.gathered:
            gathers += micro * n(axes)
            scatters += micro * n([a for a in plan.sum_axes if a in axes])
            reduces += micro * n([a for a in plan.sum_axes if a not in axes])
        else:
            reduces += n(plan.sum_axes)
        if tcfg.optimizer.moments_dtype == "int8" and Q8Layout.cuts(p, mesh):
            reduces += 2 * n(sharding.spec_axes(p.spec[-1]))
            gathers += 2 * n(sharding.spec_axes(opt_m[f"{path}/scale"].spec[-1]))
    nb, nbt = n(batch), n(batch + ([tp] if tp else []))
    # remat: each period's forward runs again in the backward; with
    # remat_block each block is checkpointed inside it too, so every
    # block runs a third time (its own recompute) but the period's last,
    # whose input the period's recompute already holds
    nested = cfg.remat and cfg.remat_block and cfg.period > 1
    for i, (mixer, ffn_kind) in enumerate(cfg.layer_pattern):
        c = _block_collectives(cfg, mixer, ffn_kind, split, sp, policy, nb, nbt)
        runs = 1 + cfg.remat + (nested and i < cfg.period - 1)
        per = {k: runs * c[f"fwd_{k}"] + c[f"bwd_{k}"] for k in ("ag", "rs", "ar")}
        if c["tail"] and (nested or (cfg.remat and i == cfg.period - 1)):
            per[c["tail"]] -= 1
        gathers += micro * cfg.num_periods * per["ag"]
        scatters += micro * cfg.num_periods * per["rs"]
        reduces += micro * cfg.num_periods * per["ar"]
    vocab = "vocab" in split
    if tp is not None and vocab:
        tokens = cfg.input_kind != "embeddings"
        if sp:
            gathers += micro * (1 + tokens)
            scatters += micro * (1 + tokens)
        else:
            reduces += micro * (1 + tokens)
        chunk = min(tcfg.seq_chunk, seq)
        chunks = seq // chunk if seq % chunk == 0 else 1
        reduces += micro * 2 * chunks
    reduces += micro * n(batch) + n(batch) + (1 if mesh.size > 1 else 0) * (
        1 + int(tcfg.ef_compression))
    return {"all_gather": gathers, "reduce_scatter": scatters, "all_reduce": reduces}


# ---------------------------------------------------------------------------
# Roofline over dry-run records
# ---------------------------------------------------------------------------

def model_flops(total_params: int, active_params: int, tokens: int, kind: str) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference, N = active."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params * tokens


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int
    compute_s_by_class: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time model: overlapped execution -> max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_from_artifact(art: Dict, hw: Optional[HW] = None) -> RooflineTerms:
    """art: one dry-run record (``launch/dryrun.py``); every count in it is
    one rank's.  Compute: ``static["ops_by_class"]`` (the float products
    by dtype and the kernels' operations) at each class' peak; memory:
    ``cost["bytes accessed"]``; collectives: ``static
    ["collective_bytes_by_axis"]`` at each axis' link rate."""
    hw = hw or HW()
    static = art.get("static") or {}
    by_class = {k: v / hw.peak(k) for k, v in static.get("ops_by_class", {}).items()}
    by_axis = static.get("collective_bytes_by_axis", {})
    return RooflineTerms(
        compute_s=sum(by_class.values()),
        memory_s=float(art["cost"].get("bytes accessed", 0.0)) / hw.hbm_bw,
        collective_s=sum(b / hw.link_bw(ax) for ax, b in by_axis.items()),
        flops=float(art["cost"].get("flops", 0.0)),
        bytes_accessed=float(art["cost"].get("bytes accessed", 0.0)),
        coll_bytes=float((art.get("collectives") or {}).get("total", 0.0)),
        chips=int(art.get("num_devices", 1)),
        compute_s_by_class=by_class,
    )
