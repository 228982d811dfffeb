"""Batched serving engine: model step functions + a continuous-batching
scheduler (serving/scheduler.py) over fixed decode slots.

Counterpart of ``repro/serving/engine.py``.  The step functions are
plain functions (the reference jits them; PyTorch runs eagerly):

* ``make_serve_step``  — one new token for every slot against the full
  cache;
* ``make_prefill_fn``  — run a prompt through the model, filling caches;
* ``make_chunk_step``  — advance every prefilling slot by one
  prefill_chunk of its prompt (paged engines only).

The scheduling strategy follows the cache storage
(``ModelConfig.kv_cache_dtype`` via ``models/common.kv_cache_format``):
dense ("bf16"/"int8") slabs get bucket prefill and batch-row insertion
(:class:`BucketScheduler`); paged ("tnn2"/"tnn2-oracle") ternary pages
get chunked prefill interleaved with decode (:class:`ChunkedScheduler`).
Either way finished slots (EOS / max_new / max_len / deadline /
cancel()) free at once and refill without stopping the others.

The engine runs on the device of the parameters it is given and never
moves them: caches, token tensors and the sampling generator are made
there.

Serving on a mesh (``ServeConfig.mesh``, a
:class:`repro_torch.launch.mesh.Mesh`): every rank of the mesh builds the
same Engine on the same raw parameters and gets the same requests (SPMD).
Packing then keeps each rank's slice of the bit planes and every
projection dispatches the mesh qmm (``parallel/qmm_mesh.py``: integer
partial counts all-reduced, eq. (2) after the sum); float leaves are
replicated.  The engine enters ``sharding.use_mesh(mesh,
RULESETS[mesh_rules])`` around packing, autotuning, prefill and decode.
The ranks' schedulers check every tick that they agree
(``serving/scheduler.py``), and a mesh engine's ``run()`` lets a step's
exception through instead of quarantining it, because a rank that
skipped a step would pair its next collective with another rank's.
``make_watchdog`` gives a heartbeat watchdog with one "host" per rank and
``rebuild_after_loss`` re-plans the mesh on the surviving ranks
(``runtime.elastic.plan_restart``: the model axis pinned, the data axis
shrunk), re-packs the raw parameters onto it and migrates the unfinished
requests, which restart from their prompts.  Every rank of the world calls
it (process groups are created collectively); a rank left out of the new
mesh gets None and leaves.  This covers the reference's contract, a rank
falling silent while all ranks can still form groups: a rank that really
dies takes its ``torch.distributed`` world with it, and recovering from
that is a ``torchrun`` restart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.models import model as model_mod
from repro_torch.models.common import ModelConfig, ShardLayout, kv_cache_format
from repro_torch.models.kvcache import init_caches
from repro_torch.models.paged_kvcache import tree_nbytes
from repro_torch.parallel import sharding
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (BucketScheduler, ChunkedScheduler, Request,
                                           Result)

__all__ = ["ServeConfig", "Request", "Result", "Engine", "make_serve_step",
           "make_serve_step_embeddings", "make_prefill_fn", "make_chunk_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    num_slots: int = 8
    max_len: int = 512
    prefill_bucket: int = 128     # prompts padded up to a power-of-two multiple
    # Paged (kv_cache_dtype "tnn2"/"tnn2-oracle") engines replace the
    # bucket prefill with chunked prefill: prefill_chunk tokens per tick,
    # interleaved with decode, over page_size-token pages.
    page_size: int = 16
    prefill_chunk: int = 32
    eos_id: int = -1              # -1: only stop at max_new_tokens
    # Record every sampled step's pre-sampling logits row per request uid
    # (host copies — Engine.logit_trace).
    trace_logits: bool = False
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    # Pack low-bit projection weights into QTensors at engine build (the
    # paper's offline Algorithm 2; models/packing.pack_lm_params): every
    # projection then runs one fused qmm.  A tree that is packed already
    # passes through unchanged.
    pack_params: bool = False
    # Kernel autotuning of the packed projections (repro_torch.tune):
    #   "off"          — dispatch uses cached plans if present, else the
    #                    untuned choice; never measures.
    #   "offline"      — at build, tune every packed (mode, k, n) at the
    #                    decode m (num_slots) and each prefill m, and
    #                    persist the plans (REPRO_TUNE_CACHE).
    #   "on_first_use" — each new qmm shape is tuned on its first call.
    # Only with pack_params=True.  The on-first-use switch is process
    # wide: building a pack_params engine applies its setting, and
    # Engine.close() disarms it.
    autotune: str = "off"
    # Input extents for conv-packed QTensors in an "offline" sweep:
    # (batch, height, width[, stride, padding]).
    tune_conv_inputs: tuple = ()
    # Serve on a mesh of ranks (launch.mesh.Mesh; module docstring): every
    # rank builds the engine with the same parameters and requests.
    # None = one device.
    mesh: Optional[Any] = None
    mesh_rules: str = "serve_lowbit"
    # Backpressure: a submit past this bound resolves at once as
    # "rejected".  None = unbounded.
    max_queue: Optional[int] = None
    # Page-exhaustion preemption: retry r waits
    # min(retry_backoff_s * 2**(r-1), retry_backoff_cap_s).
    retry_backoff_s: float = 0.05
    retry_backoff_cap_s: float = 1.0
    # NaN/Inf guard: a row whose logits go non-finite finishes as
    # "numeric_error" (one host read per tick).
    numeric_guard: bool = True


# --------------------------------------------------------------------------
# Step functions
# --------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, layout: ShardLayout,
                    scfg: Optional[ServeConfig] = None):
    """serve_step(params, caches, tokens (B,1), step (B,), generator) ->
    (next_tokens (B,), logits (B,Vp), caches written in place)."""
    scfg = scfg or ServeConfig()
    sampler = dataclasses.replace(scfg.sampler, vocab_size=cfg.vocab_size)

    def serve_step(params, caches, tokens, step, generator):
        logits, caches = model_mod.decode_step(params, {"tokens": tokens}, caches, step,
                                               cfg, layout)
        return sample(logits[:, -1, :], generator, sampler), logits[:, -1, :], caches

    return serve_step


def make_serve_step_embeddings(cfg: ModelConfig, layout: ShardLayout,
                               scfg: Optional[ServeConfig] = None):
    """Variant for input_kind='embeddings' archs (musicgen): the decode
    input is the previous frame embedding."""
    scfg = scfg or ServeConfig()
    sampler = dataclasses.replace(scfg.sampler, vocab_size=cfg.vocab_size)

    def serve_step(params, caches, embeddings, step, generator):
        logits, caches = model_mod.decode_step(params, {"embeddings": embeddings}, caches,
                                               step, cfg, layout)
        return sample(logits[:, -1, :], generator, sampler), logits[:, -1, :], caches

    return serve_step


def make_prefill_fn(cfg: ModelConfig, layout: ShardLayout):
    """prefill(params, caches, batch) -> (last logits (B,1,Vp), caches)."""

    def prefill_fn(params, caches, batch):
        return model_mod.prefill(params, batch, caches, cfg, layout)

    return prefill_fn


def make_chunk_step(cfg: ModelConfig, layout: ShardLayout):
    """chunk_step(params, caches, tokens (B,C), step2 (B,2)) ->
    (logits (B,C,Vp), caches): ``step2[b] = (start, n)`` advances slot b
    by its next n prompt tokens (n == 0: a dead row)."""

    def chunk_step(params, caches, tokens, step2):
        return model_mod.decode_step(params, {"tokens": tokens}, caches, step2, cfg, layout)

    return chunk_step


def _tree_device(tree) -> torch.device:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _tree_device(v)
            if dev is not None:
                return dev
        return None
    return getattr(tree, "device", None)


class Engine:
    """Continuous-batching inference engine over static decode slots."""

    def __init__(self, params, cfg: ModelConfig, layout: ShardLayout,
                 scfg: ServeConfig, seed: int = 0, clock=None):
        if scfg.autotune not in ("off", "offline", "on_first_use"):
            raise ValueError(
                f"ServeConfig.autotune must be 'off', 'offline' or "
                f"'on_first_use', got {scfg.autotune!r}")
        if scfg.mesh is not None and scfg.mesh_rules not in sharding.RULESETS:
            raise ValueError(
                f"ServeConfig.mesh_rules must be one of "
                f"{sorted(sharding.RULESETS)}, got {scfg.mesh_rules!r}")
        self.cfg, self.layout, self.scfg = cfg, layout, scfg
        self._seed, self._clock = seed, clock
        self._raw_params = params     # retained for the elastic rebuild
        self._closed = False
        self._paged = kv_cache_format(cfg.kv_cache_dtype).paged
        self.device = _tree_device(params)
        if self.device is None:
            raise ValueError("Engine needs a parameter tree holding tensors")
        if scfg.mesh is not None:
            from repro_torch.launch.mesh import Mesh
            if not isinstance(scfg.mesh, Mesh):
                raise TypeError(f"ServeConfig.mesh must be a launch.mesh.Mesh, got "
                                f"{type(scfg.mesh).__name__}")
            if not scfg.mesh.member or scfg.mesh.device != self.device:
                raise ValueError(f"this rank serves on {self.device}, which is not a "
                                 f"member of {scfg.mesh!r}")
        # per-engine telemetry + event sink (REPRO_OBS=off: every hook is
        # a no-op and the sink never opens)
        self.obs = EngineMetrics()
        if self._paged and cfg.input_kind == "embeddings":
            raise NotImplementedError(
                "paged (tnn2) serving covers token models; the embeddings "
                "frontend has no chunked-prefill token source")
        # plan key -> the per-candidate timings of each plan an "offline"
        # sweep measured (tuner.ensure_plan's reports)
        self.tune_reports: Dict[str, Dict] = {}
        with self._mesh_scope():
            if scfg.pack_params:
                from repro_torch.models.packing import pack_lm_params
                params = pack_lm_params(params, cfg)
            self.params = params
            if scfg.pack_params:
                self._autotune()
        b, L = scfg.num_slots, scfg.max_len
        self.caches = init_caches(cfg, layout, b, L, page_size=scfg.page_size,
                                  prefill_chunk=scfg.prefill_chunk, device=self.device)
        if not self._paged:
            self._prefill_caches = {s: init_caches(cfg, layout, 1, L, device=self.device)
                                    for s in self._buckets()}
        if self.obs.enabled:
            # footprint vs a bf16 slab of the same (slots, max_len): shapes
            # only, on the meta device — nothing is allocated for it
            dense_equiv = init_caches(cfg, layout, b, L, torch.bfloat16, device="meta")
            self.obs.set_kv_bytes(tree_nbytes(self.caches), tree_nbytes(dense_equiv))
        self.serve_step = self._annotated(make_serve_step(cfg, layout, scfg), "decode_step")
        if self._paged:
            self.chunk_step = self._annotated(make_chunk_step(cfg, layout), "prefill_chunk")
        else:
            self.prefill = self._annotated(make_prefill_fn(cfg, layout), "prefill_bucket")
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        sched_cls = ChunkedScheduler if self._paged else BucketScheduler
        self._sched = sched_cls(self, clock=clock)
        self.obs.events.emit(
            "engine_build", kv_cache_dtype=cfg.kv_cache_dtype, num_slots=scfg.num_slots,
            max_len=scfg.max_len, paged=self._paged, autotune=scfg.autotune,
            mesh=None if scfg.mesh is None else list(scfg.mesh.shape))

    @staticmethod
    def _annotated(fn, name: str):
        """A step function run without autograd, as a named region in
        torch.profiler traces (nullcontext when obs is off)."""
        def wrapped(*args, **kwargs):
            with obs.annotate(name), torch.no_grad():
                return fn(*args, **kwargs)
        return wrapped

    # Slot/queue state lives on the scheduler; these views keep the
    # reference's introspection surface.
    @property
    def queue(self):
        return self._sched.queue

    @property
    def slot_uid(self):
        return self._sched.slot_uid

    @property
    def slot_pos(self):
        return self._sched.slot_pos

    @property
    def slot_remaining(self):
        return self._sched.slot_remaining

    @property
    def slot_tokens(self):
        return self._sched.slot_tokens

    @property
    def last_token(self):
        return self._sched.last_token

    @property
    def results(self):
        return self._sched.results

    @property
    def logit_trace(self):
        """uid -> [logits row per sampled step] (ServeConfig.trace_logits)."""
        return self._sched.logit_trace

    @contextlib.contextmanager
    def _mesh_scope(self):
        """The engine's mesh and ruleset for the duration of a call
        (packing, autotuning, prefill, decode), scoped per call, so two
        engines on different meshes (the rebuild window) never share an
        ambient mesh."""
        if self.scfg.mesh is None:
            yield
            return
        with sharding.use_mesh(self.scfg.mesh, sharding.RULESETS[self.scfg.mesh_rules]):
            yield

    def _buckets(self):
        out, s = [], self.scfg.prefill_bucket
        while s <= self.scfg.max_len:
            out.append(s)
            s *= 2
        return out or [self.scfg.max_len]

    # -------------------------------------------------------- autotuning

    def _autotune(self):
        """Wire the packed projections into the autotuner.

        "offline": tune every distinct packed (mode, k, n) at the
        engine's own m extents — decode at m = num_slots, bucket prefill
        at m = each bucket, chunked prefill at m = num_slots x
        prefill_chunk — on the engine's device, then persist the plans.
        Under a mesh the sharded containers' kernels see their LOCAL
        problems (``qmm_mesh.local_dims``: the fused kernel at n_local for
        n-sharded planes, the int32 core at k_local for k-sharded ones),
        so those are swept too.
        "on_first_use": arm the process-wide policy.  "off"/"offline"
        disarm it, so an "off" engine never measures at dispatch time.
        """
        from repro_torch.kernels.modes import DEFAULT_BACKEND
        from repro_torch.tune import cache as tune_cache

        if self.scfg.autotune == "on_first_use":
            tune_cache.set_policy("on_first_use")
            return
        tune_cache.set_policy("off")
        if self.scfg.autotune == "off":
            return
        from repro_torch.tune import tuner

        problems = tuner.collect_problems(self.params)
        if self._paged:
            ms = sorted({self.scfg.num_slots, self.scfg.num_slots * self.scfg.prefill_chunk})
        else:
            ms = sorted({self.scfg.num_slots, *self._buckets()})
        for mode, k, n, geometry in problems:
            if geometry is None:
                for m in ms:
                    tuner.ensure_plan(mode, DEFAULT_BACKEND, fused=True, m=m, n=n, k=k,
                                      save=False, reports=self.tune_reports,
                                      device=self.device)
            else:
                for entry in self.scfg.tune_conv_inputs:
                    bsz, h, w = entry[:3]
                    prob = tuner.ConvProblem.from_input(
                        (bsz, h, w, geometry[2]), geometry,
                        stride=entry[3] if len(entry) > 3 else 1,
                        padding=entry[4] if len(entry) > 4 else "SAME")
                    tuner.ensure_plan(mode, DEFAULT_BACKEND, fused=True, conv=prob,
                                      save=False, reports=self.tune_reports,
                                      device=self.device)
        ctx = sharding.active()
        if ctx is not None:
            from repro_torch.parallel import qmm_mesh
            seen = set()
            for qt in _lowbit_gemm_containers(self.params):
                plan = qmm_mesh.shard_plan(qt, ctx)
                if plan is None:
                    continue
                n_l, k_l = qmm_mesh.local_dims(qt, ctx)
                key = (qt.mode, plan.k_axis is None, n_l, k_l)
                if key in seen:
                    continue
                seen.add(key)
                for m in ms:
                    tuner.ensure_plan(qt.mode, DEFAULT_BACKEND, fused=plan.k_axis is None,
                                      m=m, n=n_l, k=k_l, save=False,
                                      reports=self.tune_reports, device=self.device)
            problems = problems or seen
        if problems:
            try:
                tune_cache.get_cache().save()
            except Exception as e:
                # the plans stay live in memory; a failed persist must not
                # fail the build
                tune_cache.contained("save", e)

    def submit(self, req: Request):
        self._sched.submit(req)

    # ------------------------------------------------- scheduler delegation

    def step(self) -> bool:
        """One continuous-batching tick (expire -> admit/prefill ->
        decode); True while any request is queued or in flight."""
        with self._mesh_scope():
            return self._sched.step()

    def page_stats(self):
        """Per-pattern-entry page accounting ({total, used, free,
        high_water}) for paged engines; [] for dense ones."""
        if not self._paged:
            return []
        return self._sched.page_stats()

    # ------------------------------------------------------------- obs

    def metrics(self) -> Dict:
        """This engine's metrics snapshot (its own registry)."""
        return self.obs.snapshot()

    def snapshot(self) -> Dict:
        """Full obs export: run/engine identity, this engine's metrics,
        and the process-wide (kernel/tune/fault) registry."""
        return {"meta": {"run": obs.run_id(), "engine": self.obs.engine_id,
                         "kv_cache_dtype": self.cfg.kv_cache_dtype,
                         "num_slots": self.scfg.num_slots, "paged": self._paged},
                "engine": self.obs.snapshot(),
                "process": obs.get_registry().snapshot()}

    # --------------------------------------------------------------- run

    def run(self, max_steps: int = 10_000) -> Dict[int, Result]:
        """Drive the scheduler until every request resolves (or
        ``max_steps``).  A step that raises — a failed CUDA launch, an
        injected fault — is quarantined: every in-flight slot finishes
        as "error" (pages released) and the loop goes on with the
        queue.  ``Engine.step()`` stays raising.  On a mesh a step's
        exception propagates (module docstring)."""
        steps = 0
        with self._mesh_scope():
            while (self.queue or any(u != -1 for u in self.slot_uid)) and steps < max_steps:
                try:
                    self._sched.step()
                except Exception as e:
                    if self.scfg.mesh is not None:
                        raise
                    self._sched.quarantine(e)
                steps += 1
        return self.results

    # ------------------------------------------------------------ lifecycle

    def close(self):
        """Release the process-global and sink state this engine holds,
        once: disarm the process-wide "on_first_use" policy it armed,
        release every page stranded slots hold, emit ``engine_close``
        (with the in-flight count before the release) and close the
        event sink."""
        if self._closed:
            return
        self._closed = True
        if self.scfg.pack_params and self.scfg.autotune == "on_first_use":
            from repro_torch.tune import cache as tune_cache
            tune_cache.set_policy("off")
        in_flight = sum(1 for u in self.slot_uid if u != -1)
        with self._mesh_scope():
            self._sched.shutdown()
        self.obs.events.emit("engine_close", results=len(self.results), in_flight=in_flight)
        self.obs.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def make_watchdog(self, cfg: Optional[Any] = None, clock: Optional[Any] = None):
        """Heartbeat watchdog sized to this engine's mesh: one "host" per
        rank, host ``h`` standing for rank ``mesh.devices.flat[h]``."""
        from repro_torch.runtime.fault_tolerance import Watchdog, WatchdogConfig

        if self.scfg.mesh is None:
            raise RuntimeError("make_watchdog needs a mesh engine")
        cfg = cfg or WatchdogConfig()
        n = self.scfg.mesh.size
        if clock is None:
            return Watchdog(cfg, n)
        return Watchdog(cfg, n, clock=clock)

    def rebuild_after_loss(self, dead: Sequence[Any]) -> Optional["Engine"]:
        """Rebuild this engine on the ranks that survived a loss.

        ``dead`` lists the global ranks (``mesh.devices`` entries) the
        watchdog declared lost.  ``runtime.elastic.plan_restart`` picks
        the largest restartable (data, model) topology: the model axis is
        pinned, the data axis shrinks to the largest surviving divisor.
        Every rank of the world calls this (the new mesh's process groups
        are created collectively).  On a rank of the new mesh it returns
        a new Engine that re-packed the RAW parameter tree onto that mesh
        (packing is deterministic) and holds every unfinished request of
        this one, restarted from its prompt; the integer partials sum to
        the same accumulators on any shard count, so greedy decode gives
        the same tokens.  On a rank left out (the dead ones among them)
        it returns None.  Raises RuntimeError when fewer ranks survive
        than one model-parallel group needs, and on a non-mesh engine.
        """
        if self.scfg.mesh is None:
            raise RuntimeError("rebuild_after_loss needs a mesh engine")
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.runtime.elastic import plan_restart

        mesh = self.scfg.mesh
        dead_ids = {int(getattr(d, "id", d)) for d in dead}
        all_ranks = [int(r) for r in mesh.devices.flat]
        survivors = [r for r in all_ranks if r not in dead_ids]
        self.obs.events.emit("device_loss", dead=sorted(dead_ids), survivors=len(survivors),
                             mesh=list(mesh.shape))
        t0 = time.perf_counter()
        # the rebuild event records the outcome even when re-planning or
        # re-packing raises; the sink stays open (this engine owns it)
        try:
            sizes = dict(zip(mesh.axis_names, mesh.shape))
            plan = plan_restart(len(survivors), chips_per_pod=len(all_ranks),
                                model=sizes.get("model", 1), old_data=sizes.get("data", 1),
                                old_pods=1)
            if plan is None:
                raise RuntimeError(
                    f"{len(survivors)} surviving ranks cannot host one model-parallel "
                    f"group of {sizes.get('model', 1)}")
            new_mesh = make_mesh(plan.mesh_shape(multi_pod=False), mesh.axis_names,
                                 ranks=survivors, device=mesh.device)
            new_eng = None
            if new_mesh.member:
                new_eng = Engine(self._raw_params, self.cfg, self.layout,
                                 dataclasses.replace(self.scfg, mesh=new_mesh),
                                 seed=self._seed, clock=self._clock)
        except BaseException as e:
            self.obs.events.emit("rebuild", ok=False, error=f"{type(e).__name__}: {e}",
                                 latency_s=round(time.perf_counter() - t0, 6))
            raise
        self.obs.events.emit(
            "rebuild", ok=True, new_engine=None if new_eng is None else new_eng.obs.engine_id,
            mesh=list(new_mesh.shape), member=new_mesh.member,
            latency_s=round(time.perf_counter() - t0, 6))
        if new_eng is None:
            return None
        # unfinished work restarts from scratch on the new engine: its
        # partial decode state lived in this mesh's caches; resolved
        # Results stay with this engine
        migrated = []
        for req in self._sched.unfinished():
            req.retries = 0
            req.not_before = None
            new_eng.submit(req)
            migrated.append(req.uid)
        if migrated:
            self.obs.events.emit("migrate", count=len(migrated), uids=sorted(migrated),
                                 new_engine=new_eng.obs.engine_id)
        return new_eng


def _lowbit_gemm_containers(tree) -> List[Any]:
    """Every low-bit GeMM (non-conv) QTensor of a parameter tree."""
    from repro_torch.kernels.qtensor import QTensor

    if isinstance(tree, QTensor):
        return [tree] if tree.is_lowbit and tree.geometry is None else []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [qt for v in tree for qt in _lowbit_gemm_containers(v)]
    return []
