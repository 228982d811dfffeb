"""Closed-loop packed prefill: one forward after another.

Traffic parameters: ``batch`` prompts of ``prompt_len`` token ids a
forward, drawn uniformly from the vocabulary by the seed, a ``pool`` of
such batches (more than a window completes, so every forward's prompts
differ); the quantization ``policy`` the weights are packed under;
``warmup`` forwards in set-up; ``profile_units`` forwards in the traced
stretch; ``rerun``: how many of the window's forwards, drawn from the
seed, run once more after it with their stages recorded.  A unit: a
fresh cache, ``models.model.prefill`` on the packed tree, the last
position's logits copied to the host.

Check.  A ternary network's thresholds turn on the last bits of its
activations, so two sound runs of 48 layers part ways; the reference
therefore follows the program stage by stage from the program's own
inputs to each stage.  After the window (and the traced stretch) the
drawn forwards run again through the same packed tree with their stages
recorded (``lm.Recorder``; the first of them every layer, each its
head's input), so the window itself runs unobserved:

* ``rerun_err``: max |logits| difference between each recorded forward
  and the window's forward over the same prompts (the recorded forwards
  are the timed path);
* ``embed_err``: the first layer's input against the embedding rows of
  the prompts (exact);
* ``layer_err``: each layer's output against the reference layer on the
  program's input to it, over the norm of what the reference layer added
  (the worst layer);
* ``final_err``: the logits against the final norm and head on the
  program's last layer output;
* ``logit_err``: in each recorded forward, the logits against the head
  on the program's normed last position.

The logit numbers are ``max |logits - ref| / std(ref)``, the worst row.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from gpubench import harness, lm
from gpubench.work import roofline


class Run:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from repro_torch.models.common import ShardLayout
        from repro_torch.models.packing import pack_lm_params

        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.ref = harness.load_module("reference", cfg["name"])
        self.batch, self.length = tr["batch"], tr["prompt_len"]
        self.mcfg = lm.model_config(cfg, quant_policy=tr["policy"])
        self.layout = ShardLayout()
        params = self.ref.make_params(cfg, seed, device, lm.DTYPES[cfg["dtype"]])
        self.packed = pack_lm_params(params, self.mcfg)
        del params
        tokens = self.ref.make_tokens(cfg, seed, tr["pool"], self.batch, self.length)
        self.tokens = torch.from_numpy(tokens).to(device)
        self.recorded = None
        self.outputs: List[tuple] = []
        for i in range(tr["warmup"]):
            self.step(i)
        self.outputs.clear()

    def _forward(self, j: int) -> torch.Tensor:
        from repro_torch.models import model
        from repro_torch.models.kvcache import init_caches

        with torch.no_grad():
            caches = init_caches(self.mcfg, self.layout, self.batch, self.length,
                                 device=self.device)
            logits, _ = model.prefill(self.packed, {"tokens": self.tokens[j]}, caches,
                                      self.mcfg, self.layout)
            return logits[:, 0, :self.cell.config["vocab_size"]].cpu()

    def step(self, i: int) -> None:
        j = i % self.tokens.shape[0]
        with torch.profiler.record_function("gpubench.prefill.forward"):
            self.outputs.append((j, self._forward(j)))

    def record(self) -> None:
        """Run ``rerun`` of the window's forwards (drawn from the seed) once
        more with their stages recorded: every layer in the first, the
        head's input in each."""
        rng = np.random.default_rng(self.ref.sub_seed(self.seed, 3))
        n = min(self.cell.traffic["rerun"], len(self.outputs))
        picked = [int(k) for k in rng.choice(len(self.outputs), n, replace=False)]
        recorder = lm.Recorder(self.cell.config["num_layers"])
        self.recorded = []
        for r, k in enumerate(picked):
            j = self.outputs[k][0]
            with recorder.recording(r == 0):
                out = self._forward(j)
            self.recorded.append({"k": k, "j": j, "logits": out, "head": recorder.head[:, 0],
                                  "layers": recorder.layers})

    def units_for_trace(self) -> int:
        return self.cell.traffic["profile_units"]

    def end_to_end(self, window: harness.Window) -> Dict[str, Any]:
        tokens = window.done * self.batch * self.length
        return {"prefill_tokens_per_s": (tokens / window.seconds, "tokens/s")}

    def work(self) -> Dict[str, Any]:
        cfg = self.cell.config
        return {"step": roofline.prefill_step_work(cfg, self.batch, self.length),
                "gemm": roofline.prefill_kernel_work(cfg, self.batch, self.length)}

    def release(self) -> None:
        self.packed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _numbers(self, float_dtype) -> Dict[str, Any]:
        """Each stage's output as the reference gives it in ``float_dtype``
        from the program's recorded inputs."""
        cfg, ref, dev = self.cell.config, self.ref, self.device
        params = ref.make_params(cfg, self.seed, dev, lm.DTYPES[cfg["dtype"]])
        first = self.recorded[0]
        per_layer = ref.layer_params(params, cfg)
        return {"embed": ref.embed(params, self.tokens[first["j"]], cfg),
                "layers": [ref.layer(p, x.to(dev), cfg, float_dtype) for p, (x, _) in
                           zip(per_layer, first["layers"])],
                "final": ref.final_logits(params, first["layers"][-1][1].to(dev), cfg,
                                          float_dtype),
                "head": [ref.head(params, r["head"].to(dev), cfg, float_dtype)
                         for r in self.recorded]}

    def _compare(self, got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
        inputs = [x for x, _ in self.recorded[0]["layers"]]
        return {"rerun_err": got["rerun"],
                "embed_err": lm.max_abs_err(got["embed"], want["embed"]),
                "layer_err": lm.layer_err(got["layers"], want["layers"], inputs),
                "final_err": lm.logit_err(got["final"], want["final"]),
                "logit_err": max(lm.logit_err(g, w) for g, w in zip(got["head"], want["head"]))}

    def _program(self) -> Dict[str, Any]:
        first = self.recorded[0]
        return {"rerun": max(lm.max_abs_err(r["logits"], self.outputs[r["k"]][1])
                             for r in self.recorded),
                "embed": first["layers"][0][0], "layers": [y for _, y in first["layers"]],
                "final": first["logits"], "head": [r["logits"] for r in self.recorded]}

    def check(self) -> Dict[str, float]:
        if not self.recorded:
            raise RuntimeError("no forward was recorded after the window")
        return self._compare(self._program(), self._numbers(torch.float32))

    def control(self) -> Dict[str, float]:
        """The numbers of the reference with its float32 work in bfloat16
        in the program's place, from the same recorded inputs."""
        return self._compare({**self._numbers(torch.bfloat16), "rerun": 0.0},
                             self._numbers(torch.float32))
