"""Closed-loop CNN inference: one batch in flight.

Traffic parameters: ``batch`` images a batch, a ``pool`` of distinct
N(0, 1) batches made from the seed and kept in pinned host memory,
cycled; ``backend`` of the low-bit convs; ``warmup`` batches in set-up;
``profile_units`` batches in the traced stretch.  A unit: copy a batch
to the card, ``PaperCNN.forward``, copy the logits back into pinned host
memory.

Check.  A ternary network's thresholds turn on the last bits of its
activations, so two sound implementations part ways over five ternary
convs (end to end, an image's logits differ by 4-8%; the bf16 control
by 14-29%); the reference therefore follows the program conv by conv.
After the window (and the traced stretch) every pool batch the run drove
runs once more through the same model, with a forward hook on each conv
module (``PaperCNN.layers[i]``, the conv of ``convs[i]``) recording its
output on the device; the model is then freed.

* ``rerun_err``: max |logits| difference between every batch of the
  window (and of the traced stretch) and the recorded pass over the same
  images (the recorded passes are the timed path's);
* ``layer_err``: in each recorded pass, each conv's output against the
  reference conv on the reference's glue (ReLU, pool) of the program's
  previous conv output (the images for the first): ||got - ref|| /
  ||ref|| over the batch (the nearer where a tie at the ternary threshold
  gives the reference two outputs), the worst layer of the worst pass
  (one activation that a last bit flips moves one image of a small map
  by up to a few percent, so an image's own error is no steady number);
* ``head_err``: the recorded logits against the reference head (glue,
  spatial mean, classifier) on the program's last conv output, the
  worst image.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from gpubench import harness
from gpubench.work import roofline


def _whole(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole tensor; 1.0 where the shapes
    differ."""
    if got.shape != want.shape:
        return 1.0
    want = want.to(torch.float32)
    return float((got.to(torch.float32) - want).norm() / want.norm().clamp(min=1e-30))


def _rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst image's ||got - want|| / ||want|| (0 where both are 0);
    1.0 where the shapes differ."""
    if got.shape != want.shape:
        return 1.0
    got, want = got.to(torch.float32).flatten(1), want.to(torch.float32).flatten(1)
    return float(((got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)).max())


class Run:
    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from repro_torch.cnn import PaperCNN
        from repro_torch.configs.paper_cnn import CNNConfig, ConvSpec

        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.ref = harness.load_module("reference", cfg["name"])
        self.batch = tr["batch"]
        self.filters, self.classifier = self.ref.make_weights(cfg, seed, device)
        program_cfg = CNNConfig(
            name=cfg["name"], img_size=cfg["img_size"], c_in=cfg["c_in"],
            num_classes=cfg["num_classes"], accum_bits=cfg["accum_bits"],
            convs=tuple(ConvSpec(c_out=c["c_out"], kernel=c["kernel"], stride=c["stride"],
                                 mode=c["mode"], pool=c["pool"]) for c in cfg["convs"]))
        self.model = PaperCNN(program_cfg, filters=self.filters, classifier=self.classifier,
                              device=device, backend=tr["backend"])
        images = self.ref.make_images(cfg, seed, tr["pool"], self.batch, device).cpu()
        pin = device.type == "cuda"
        self.pool = images.pin_memory() if pin else images
        self.host_logits = torch.empty((self.batch, cfg["num_classes"]), pin_memory=pin)
        self.outputs: List[tuple] = []
        self.recorded = None
        for i in range(tr["warmup"]):
            self.step(i)
        self.outputs.clear()

    def _forward(self, j: int) -> torch.Tensor:
        with torch.no_grad():
            x = self.pool[j].to(self.device, non_blocking=True)
            return self.model(x)

    def step(self, i: int) -> None:
        j = i % self.pool.shape[0]
        with torch.profiler.record_function("gpubench.cnn.batch"):
            self.host_logits.copy_(self._forward(j), non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.outputs.append((j, self.host_logits.clone()))

    def units_for_trace(self) -> int:
        return self.cell.traffic["profile_units"]

    def end_to_end(self, window: harness.Window) -> Dict[str, Any]:
        return {"images_per_s": (window.done * self.batch / window.seconds, "images/s"),
                "image_batch_p95_ms": (harness.percentile(window.latencies, 95) * 1e3, "ms")}

    def work(self) -> Dict[str, Any]:
        return {"step": roofline.cnn_step_work(self.cell.config, self.batch),
                "conv": roofline.cnn_kernel_work(self.cell.config, self.batch)}

    def record(self) -> None:
        """Run every pool batch the run drove once more, recording every
        conv module's output."""
        self.recorded = {}
        for j in sorted({j for j, _ in self.outputs}):
            outs: List[torch.Tensor] = []
            hooks = [layer.register_forward_hook(
                lambda m, a, y: outs.append(y.detach().clone())) for layer in self.model.layers]
            try:
                logits = self._forward(j).cpu()
            finally:
                for h in hooks:
                    h.remove()
            self.recorded[j] = (logits, outs)

    def release(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _numbers(self, dtype=None) -> Dict[str, float]:
        """Each recorded pass's convs and head against the reference's, each
        on the program's previous stage; with ``dtype`` (the control) the
        reference's own in ``dtype`` in the program's place."""
        convs, ref = self.cell.config["convs"], self.ref
        layers = head = 0.0
        for j, (logits, outs) in self.recorded.items():
            if len(outs) != len(convs):
                return {"layer_err": 1.0, "head_err": 1.0}
            x = self.pool[j].to(self.device)
            for spec, w, y in zip(convs, self.filters, outs):
                got = y if dtype is None else ref.conv(spec, w, x, dtype)[0]
                layers = max(layers, min(_whole(got, want)
                                         for want in ref.conv(spec, w, x, torch.float32)))
                x = ref.glue(spec, y)
            want = ref.head(convs[-1], outs[-1], self.classifier).cpu()
            got = logits if dtype is None else ref.head(convs[-1], outs[-1], self.classifier,
                                                        dtype).cpu()
            head = max(head, _rows(got, want))
        return {"layer_err": layers, "head_err": head}

    def check(self) -> Dict[str, float]:
        if not self.recorded:
            raise RuntimeError("no batch was recorded after the window")
        rerun = max(float((out - self.recorded[j][0]).abs().max()) for j, out in self.outputs)
        return {"rerun_err": rerun, **self._numbers()}

    def control(self) -> Dict[str, float]:
        """The numbers of the reference in bfloat16 in the program's place,
        on the same recorded stages."""
        return {"rerun_err": 0.0, **self._numbers(torch.bfloat16)}
