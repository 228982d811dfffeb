"""Each cell of ``BENCHMARK.json`` at a size the CPU runs in seconds: the
same files, with the configuration cut to a few narrow layers (the CNN's
modes as its configuration has them, plus a TBN conv; Mamba2 at the
port's ``SMOKE`` sizes) and the traffic to a few small units."""

from __future__ import annotations

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gpubench import harness  # noqa: E402

CELLS = ("vgg_small.b1024", "mamba2.prefill_8x1024", "mamba2.qat_8x512")

CNN_SMOKE = {"img_size": 8, "convs": [
    {"c_out": 8, "kernel": 3, "stride": 1, "mode": "f32", "pool": False},
    {"c_out": 16, "kernel": 3, "stride": 1, "mode": "tnn", "pool": True},
    {"c_out": 16, "kernel": 3, "stride": 1, "mode": "tbn", "pool": False},
    {"c_out": 16, "kernel": 3, "stride": 1, "mode": "tnn", "pool": True}]}
MAMBA2_SMOKE = {"num_layers": 2, "d_model": 64, "vocab_size": 512, "ssm_state": 16,
                "ssm_headdim": 16, "ssm_chunk": 32}
TRAFFIC_SMOKE = {
    "vgg_small.b1024": {"batch": 16, "pool": 3, "warmup": 1, "profile_units": 2},
    "mamba2.prefill_8x1024": {"batch": 2, "prompt_len": 64, "pool": 8, "warmup": 1,
                              "profile_units": 1, "rerun": 2},
    "mamba2.qat_8x512": {"batch": 2, "seq": 64, "pool": 8, "profile_units": 1,
                         "wgrad_layers": 2},
}


def smoke_cell(name: str) -> harness.Cell:
    """Cell ``name`` with its configuration and traffic cut to smoke size."""
    cell = copy.deepcopy(harness.find_cell(name))
    cell.config.update(CNN_SMOKE if name.startswith("vgg") else MAMBA2_SMOKE)
    cell.traffic.update(TRAFFIC_SMOKE[name])
    return cell
