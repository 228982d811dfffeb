"""The port's program spans (``repro_torch.obs.annotate``) on the CPU, at
smoke sizes, under a CPU ``torch.profiler`` session:

* a VGG-Small-shaped ``PaperCNN`` forward, a 2-layer Mamba2 packed
  prefill and a 2-layer Mamba2 QAT step with remat open the spans the
  ``repro_torch.obs`` docstring lists, as many per unit as the model has
  entry-point calls (one conv statistics pass per low-bit conv; per
  Mamba2 layer two projections and one scan, a QAT step's forward run
  twice under remat, one straight-through backward per projection), and
  a 2-layer packed prefill of the published Qwen1.5-MoE block (per layer
  q, k, v, o, three projections for each of 8 experts and for the shared
  expert, and the four MoE stages once each);
* ``repro_torch.quantize`` and ``repro_torch.lowbit_kernel`` nest under
  ``repro_torch.qmm`` / ``repro_torch.qconv``;
* with no profiler session open, or with obs off, no
  ``record_function`` is entered.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.cnn import PaperCNN
from repro_torch.configs import get_smoke
from repro_torch.configs.paper_cnn import CNNConfig, ConvSpec
from repro_torch.models import model
from repro_torch.models.common import ShardLayout
from repro_torch.models.kvcache import init_caches
from repro_torch.models.packing import pack_lm_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainStepConfig, make_train_step

PREFIX = "repro_torch."
LAYOUT = ShardLayout()
# VGG-Small's stack (first conv float, five TNN convs, three pools) at
# narrow widths on 8x8 images
VGG_SMOKE = CNNConfig(
    name="vgg-small-smoke", img_size=8, c_in=3, num_classes=10, accum_bits=16,
    convs=tuple(ConvSpec(c_out=c, kernel=3, stride=1, mode=m, pool=p) for c, m, p in (
        (8, "f32", False), (8, "tnn", True), (16, "tnn", False), (16, "tnn", True),
        (32, "tnn", False), (32, "tnn", True))))


@pytest.fixture()
def obs_on():
    was = obs.obs_enabled()
    obs.set_enabled(True)
    yield
    obs.set_enabled(was)


def _spans(fn):
    """(name, start, end, thread) of every program span ``fn`` opens
    under a CPU profiler session."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith(PREFIX)]


def _counts(spans):
    return dict(collections.Counter(s[0][len(PREFIX):] for s in spans))


def _assert_nested(spans):
    """Every quantize and kernel launch span lies inside an entry point's
    span on its thread."""
    entries = [s for s in spans if s[0] in (PREFIX + "qmm", PREFIX + "qconv")]
    inner = [s for s in spans if s[0] in (PREFIX + "quantize", PREFIX + "lowbit_kernel")]
    assert inner
    for name, start, end, thread in inner:
        assert any(e[3] == thread and e[1] <= start and end <= e[2] for e in entries), name


def _cnn_unit():
    net = PaperCNN(VGG_SMOKE, seed=1, device="cpu")
    x = torch.randn((2, 8, 8, 3), generator=torch.Generator().manual_seed(2))
    return lambda: net(x)


def _mamba2(remat=False):
    cfg = get_smoke("mamba2-1.3b").with_(quant_policy="tnn", dtype=torch.float32,
                                         remat=remat)
    gen = torch.Generator().manual_seed(0)
    params = model.init_lm(gen, cfg, LAYOUT, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
    return cfg, params, tokens


def _prefill_unit():
    cfg, params, tokens = _mamba2()
    packed = pack_lm_params(params, cfg)

    def unit():
        with torch.no_grad():
            caches = init_caches(cfg, LAYOUT, tokens.shape[0], tokens.shape[1], device="cpu")
            model.prefill(packed, {"tokens": tokens}, caches, cfg, LAYOUT)
    return unit


def _moe_prefill_unit():
    """The published Qwen1.5-MoE block's packed prefill, 2 layers of 8
    experts (every one gets rows: 2 x 64 tokens, top-4)."""
    from repro_torch.configs import qwen2_moe_a2_7b

    cfg = qwen2_moe_a2_7b.SMOKE.with_(**qwen2_moe_a2_7b.PUBLISHED_SWITCHES, quant_policy="tnn",
                                      dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    packed = pack_lm_params(model.init_lm(gen, cfg, LAYOUT, device="cpu"), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)

    def unit():
        with torch.no_grad():
            caches = init_caches(cfg, LAYOUT, tokens.shape[0], tokens.shape[1], device="cpu")
            model.prefill(packed, {"tokens": tokens}, caches, cfg, LAYOUT)
    return unit


def _train_unit():
    cfg, params, tokens = _mamba2(remat=True)
    step = make_train_step(cfg, LAYOUT, TrainStepConfig(optimizer=AdamWConfig()))
    state = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
             "mask": torch.ones(tokens.shape, dtype=torch.float32)}
    return lambda: step(state, batch)


UNITS = {
    "cnn": (_cnn_unit, {"cnn.forward": 1, "qconv": 5, "quantize": 5, "lowbit_kernel": 5}),
    "prefill": (_prefill_unit, {"prefill": 1, "qmm": 4, "quantize": 4, "lowbit_kernel": 4,
                                "ssd": 2}),
    # a layer: q, k, v, o; the routed experts' grouped qmm of gate and up
    # (one quantization, two launches) and of down; the shared expert's 3,
    # in its own entry of dispatch and experts while the counts travel
    "moe_prefill": (_moe_prefill_unit, {"prefill": 1, "qmm": 18, "quantize": 18,
                                        "lowbit_kernel": 20, "moe.route": 2, "moe.dispatch": 4,
                                        "moe.experts": 4, "moe.combine": 2}),
    "train": (_train_unit, {"train.step": 1, "train.forward": 1, "train.backward": 1,
                            "train.optimizer": 1, "weight_pack": 8, "qmm": 8, "quantize": 8,
                            "lowbit_kernel": 8, "ssd": 4, "ste_backward": 4}),
}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_unit_opens_its_spans(obs_on, unit):
    make, want = UNITS[unit]
    spans = _spans(make())
    assert _counts(spans) == want
    _assert_nested(spans)


def test_train_phases_nest_in_the_step(obs_on):
    spans = _spans(_train_unit())
    (step,) = [s for s in spans if s[0] == PREFIX + "train.step"]
    phases = [s for s in spans if s[0].startswith(PREFIX + "train.") and s is not step]
    assert [s[0] for s in sorted(phases, key=lambda s: s[1])] == [
        PREFIX + "train.forward", PREFIX + "train.backward", PREFIX + "train.optimizer"]
    assert all(step[1] <= s[1] and s[2] <= step[2] for s in phases)


def test_no_record_function_without_a_profiler(obs_on, monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __init__(self, name, args=None):
            entered.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    unit = _cnn_unit()
    unit()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        unit()
    assert len(entered) == 16
    entered.clear()
    obs.set_enabled(False)
    with profile(activities=[ProfilerActivity.CPU]):
        unit()
    assert entered == []
