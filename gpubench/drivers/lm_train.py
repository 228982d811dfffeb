"""Back-to-back QAT steps on one device.

Traffic parameters: ``batch`` sequences of ``seq`` tokens a step, drawn
uniformly from the vocabulary by the seed with numpy (labels the next
token, every position counted), a ``pool`` of such batches (more than a
run steps, so every step's rows differ); the quantization ``policy``,
``remat``, ``microbatch``, ``ef`` (error-feedback compression) and the
``optimizer`` (AdamW) of the step; ``checked_steps`` steps in set-up,
which the reference follows; ``wgrad_layers``: how many layers, drawn
from the seed, have their first weight gradients compared;
``profile_units`` steps in the traced stretch.  A unit: one call of
the step ``make_train_step`` built, on the state set-up built and drove,
and the host's read of its loss.

Check.  The first step, stage by stage from the program's own input to
each stage (recorded to the host as it runs, ``lm.Recorder``; two sound
runs of a ternary network part ways over 48 layers).  Forward: the
embedding (``embed_err``, exact) and each layer's output against the
reference layer on the program's input, over the norm of what the
reference layer added (``layer_err``, the worst layer); the loss against
the reference's final norm, head and cross-entropy on the program's last
layer output (``head_err``, relative).  Backward: the cotangent of the
last layer's output against the reference head's (``head_bwd_err``,
relative); in the drawn layers, each leaf's gradient (the program's
first moment over (1 - b1) times its clip scale) against the reference
layer's backward from the program's input and output cotangent, over
the larger of the reference's norm of that leaf and of the layer's
median leaf (``wgrad_err``, the worst).  Over the ``checked_steps``
first steps, whole: the largest relative gap of a step's loss
(``loss_gap``) and of its global gradient norm before clipping
(``gnorm_gap``); by the worst leaf, the gap between the
program's and the reference's norm of the first moment after step 1
(the clipped first gradient times 1 - b1: ``grad_gap``) and of each
parameter's change over the checked steps (``update_gap``), each over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose first gradient in the reference is under a thousandth of
the median leaf's are left out of ``update_gap``.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List

import numpy as np
import torch

from gpubench import harness, lm
from gpubench.work import roofline


def _gap(got: List[float], want: List[float], keep=None) -> float:
    floor = statistics.median(want)
    pairs = [(g, w) for i, (g, w) in enumerate(zip(got, want)) if keep is None or keep[i]]
    return max(abs(g - w) / max(w, floor) for g, w in pairs)


class Run:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from repro_torch.models.common import ShardLayout
        from repro_torch.optim.adamw import AdamWConfig, adamw_init
        from repro_torch.train.train_step import TrainStepConfig, make_train_step

        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.ref = harness.load_module("reference", cfg["name"])
        self.batch, self.length = tr["batch"], tr["seq"]
        self.mcfg = lm.model_config(cfg, quant_policy=tr["policy"], remat=tr["remat"])
        tcfg = TrainStepConfig(optimizer=AdamWConfig(**tr["optimizer"]),
                               microbatch=tr["microbatch"], ef_compression=tr["ef"])
        params = self.ref.make_params(cfg, seed, device, torch.float32)
        self.n_params = sum(self.ref.leaf(params, p).numel() for p in self.ref.LEAVES)
        self.state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
        self.train_step = make_train_step(self.mcfg, ShardLayout(), tcfg)
        toks = torch.from_numpy(self.ref.make_tokens(cfg, seed, tr["pool"], self.batch,
                                                     self.length + 1))
        self.batches = [{"tokens": t[:, :-1].to(torch.int32).to(device),
                         "labels": t[:, 1:].to(torch.int32).to(device),
                         "mask": torch.ones((self.batch, self.length), dtype=torch.float32,
                                            device=device)} for t in toks]
        self.losses: List[float] = []
        self.gnorms: List[float] = []
        recorder = lm.Recorder(cfg["num_layers"])
        with recorder.recording(True):
            self.step(0)
        self.layers, self.cotangents = recorder.layers, recorder.grads
        m = self.state["opt"]["m"]
        self.m1 = [float(torch.linalg.vector_norm(self.ref.leaf(m, p))) for p in self.ref.LEAVES]
        rng = np.random.default_rng(self.ref.sub_seed(seed, 4))
        self.wgrad_at = sorted(int(i) for i in rng.choice(cfg["num_layers"],
                                                          tr["wgrad_layers"], replace=False))
        opt = tr["optimizer"]
        unclip = (1 - opt["b1"]) * min(1.0, opt["clip_norm"] / self.gnorms[0])
        self.wgrads = {i: {p: (self.ref.leaf(m, p)[i] / unclip).cpu()
                           for p in self.ref.BLOCK_LEAVES} for i in self.wgrad_at}
        for i in range(1, tr["checked_steps"]):
            self.step(i)
        start = self.ref.make_params(cfg, seed, device, torch.float32)
        self.change = [float(torch.linalg.vector_norm(self.ref.leaf(self.state["params"], p)
                                                      - self.ref.leaf(start, p)))
                       for p in self.ref.LEAVES]
        del start

    def step(self, i: int) -> None:
        with torch.profiler.record_function("gpubench.train.step"):
            self.state, metrics = self.train_step(self.state, self.batches[i % len(self.batches)])
            self.losses.append(float(metrics["loss"]))
            self.gnorms.append(float(metrics["grad_norm"]))

    def first_window_unit(self) -> int:
        return self.cell.traffic["checked_steps"]

    def units_for_trace(self) -> int:
        return self.cell.traffic["profile_units"]

    def end_to_end(self, window: harness.Window) -> Dict[str, Any]:
        tokens = window.done * self.batch * self.length
        return {"train_tokens_per_s": (tokens / window.seconds, "tokens/s")}

    def work(self) -> Dict[str, Any]:
        cfg = self.cell.config
        return {"step": roofline.train_step_work(cfg, self.batch, self.length, self.n_params),
                "gemm": roofline.train_kernel_work(cfg, self.batch, self.length,
                                                   self.cell.traffic["remat"])}

    def release(self) -> None:
        self.state = self.train_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False) -> Dict[str, List[float]]:
        """The reference's losses, first moments and changes over the
        checked steps (with TF32 products: the control)."""
        cfg, n = self.cell.config, self.cell.traffic["checked_steps"]
        params = self.ref.make_params(cfg, self.seed, self.device, torch.float32)
        batches = [(b["tokens"], b["labels"].long()) for b in self.batches[:n]]
        out = self.ref.train_steps(cfg, self.cell.traffic["optimizer"], params, batches,
                                   matmul_tf32=tf32)
        start = self.ref.make_params(cfg, self.seed, self.device, torch.float32)
        out["change"] = [float(torch.linalg.vector_norm(self.ref.leaf(params, p)
                                                        - self.ref.leaf(start, p)))
                         for p in self.ref.LEAVES]
        return out

    def stages(self, tf32: bool = False) -> Dict[str, Any]:
        """The reference's first step stage by stage from the program's
        recorded inputs and cotangents, under the step's compute copies:
        the embedding, each layer's output, the loss from the last layer's
        output and its cotangent, and the drawn layers' gradients (with
        ``tf32``, TF32 products in each forward and in each backward
        alone: the control)."""
        cfg, ref, dev = self.cell.config, self.ref, self.device
        params = ref.make_params(cfg, self.seed, dev, torch.float32)
        copies = {"embed": params["embed"].to(torch.bfloat16),
                  "final_norm": params["final_norm"]}
        per_layer = ref.layer_params(params, cfg, compute_copies=True)
        del params
        out: Dict[str, Any] = {
            "embed": ref.embed(copies, self.batches[0]["tokens"], cfg),
            "layers": [ref.layer(p, x.to(dev), cfg, tf32=tf32)
                       for p, (x, _) in zip(per_layer, self.layers)]}
        last, labels = self.layers[-1][1], self.batches[0]["labels"]
        out["loss0"] = out["g_last"] = None     # rows left out: no loss to compare
        if last.shape[:2] == labels.shape:
            out["loss0"], gx = ref.head_vjp(copies, last.to(dev), labels, cfg,
                                            tf32_backward=tf32)
            out["g_last"] = gx.cpu()
        out["wgrads"] = {}
        for i in self.wgrad_at:
            g = self.cotangents.get(i)
            if g is not None:
                _, dw = ref.layer_vjp(per_layer[i], self.layers[i][0].to(dev), g.to(dev), cfg,
                                      tf32_backward=tf32)
                out["wgrads"][i] = {k: v.cpu() for k, v in dw.items()}
        return out

    def compare(self, got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, float]:
        floor = statistics.median(want["m1"])
        keep = [w >= 1e-3 * floor for w in want["m1"]]

        def rel(key):
            return max(abs(g - w) / abs(w) for g, w in zip(got[key], want[key]))
        return {"embed_err": lm.max_abs_err(got["embed"], want["embed"]),
                "layer_err": lm.layer_err(got["layers"], want["layers"],
                                          [x for x, _ in self.layers]),
                "head_err": 1.0 if want["loss0"] is None else
                abs(got["loss0"] - want["loss0"]) / abs(want["loss0"]),
                "head_bwd_err": lm.rel_err(got["g_last"], want["g_last"]),
                "wgrad_err": lm.leaf_err(got["wgrads"], want["wgrads"]),
                "loss_gap": rel("loss"), "gnorm_gap": rel("gnorm"),
                "grad_gap": _gap(got["m1"], want["m1"]),
                "update_gap": _gap(got["change"], want["change"], keep)}

    def check(self) -> Dict[str, float]:
        n, c = self.cell.traffic["checked_steps"], self.cotangents
        got = {"loss": self.losses[:n], "gnorm": self.gnorms[:n], "m1": self.m1,
               "change": self.change, "embed": self.layers[0][0],
               "layers": [y for _, y in self.layers], "loss0": self.losses[0],
               "g_last": c.get(len(self.layers) - 1), "wgrads": self.wgrads}
        return self.compare(got, {**self.reference(), **self.stages()})

    def control(self) -> Dict[str, float]:
        """The numbers of the reference with TF32 products in the program's
        place (in the stages' backward alone for the backward numbers)."""
        return self.compare({**self.reference(tf32=True), **self.stages(tf32=True)},
                            {**self.reference(), **self.stages()})
