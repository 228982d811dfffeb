"""The port's training path (``repro_torch.train``, the remat forward of
``models/model.py``, ``launch.train``) against the JAX package, on the
CPU, on the reference's train state carried across with
``interop.train_state_from_numpy`` and the reference's batches.

Bounds, and why:

* ``xent_loss`` (chunked, padded vocab, z-loss, softcap, tied head):
  loss ``rtol=1e-5``; its gradients w.r.t. the hidden state and the head
  weight reach them through the bf16 casts of the head product's
  operands, so they are held as a weight's gradient below (relative
  Frobenius error 5e-3, every element within 1e-2 x the largest);
* one train step under ``f32``, ``bf16`` and ``tnn`` (and ``tnn`` with
  int8 moments and EF compression) from the same state and batch: the
  loss ``rtol=2e-5``.  Every gradient leaf: its relative Frobenius error
  within ``GRAD_TOL`` and every element within 1e-2 x the leaf's largest
  magnitude.  Under ``cast_params_bf16`` each weight's gradient is
  rounded to bf16 on its way to the float32 master (``gw.astype(w.dtype)``
  in both packages), and under the ``bf16`` policy every activation
  gradient too; the two frameworks' float32 sums differ in their last
  bits, which moves a value across a bf16 rounding step (2**-8 relative)
  now and then — 1e-2 of the largest magnitude covers two such steps.
  The updated parameters: equal to the reference's ``adamw_update``
  applied to the port's own gradients from the same state within
  ``rtol=1e-6`` (``atol`` 1e-6 x the leaf's largest magnitude), which,
  with the gradient bound, holds the whole step;
* remat on == remat off, and the resumed run == the uninterrupted one:
  ``torch.equal`` (same arithmetic, same order);
* ``microbatch=2`` against 1: the first loss ``rtol=1e-4``, as
  ``tests/test_train_e2e.py`` requires of the reference;
* the Trainer's behavioural cases: the reference's own bounds.
"""

import dataclasses
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.data import DataState as JDataState
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import common as jcommon
from repro.optim import adamw as jadamw
from repro.runtime import plan_restart as jplan_restart
from repro.train import loss as jloss
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.checkpoint import restore_tree
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.common import ShardLayout
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Watchdog, WatchdogConfig
from repro_torch.train import (Trainer, TrainerConfig, TrainStepConfig, make_train_step,
                               xent_loss)
from repro_torch.train import trainer as trainer_mod
from repro_torch.train import train_step as tts
from repro_torch.tree import flatten_with_paths

JL, TL = jcommon.ShardLayout(tp=1), ShardLayout(tp=1)
ARCH = "tinyllama-1.1b"
GRAD_TOL = {"f32": 1e-3, "bf16": 5e-3, "tnn": 1e-3}


def _np(tree):
    return [(k, v.detach().cpu().double().numpy()) for k, v in flatten_with_paths(tree)]


def _from_jax(jtree):
    return interop.train_state_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _batch(vocab, seq, batch, seed=0, step=0):
    nb = JSyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=batch,
                      seed=seed).batch_at(JDataState(step, seed))
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _assert_leaf_close(got, want, rel_f, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rel_f, f"{what}: relative Frobenius error {err:.2e} > {rel_f}"
    assert np.abs(got - want).max() <= 1e-2 * scale, what


# ------------------------------------------------------------------- loss

@pytest.mark.parametrize("arch,vocab,chunk,z", [
    (ARCH, 500, 8, 0.0),            # 500 padded to 512: 12 masked columns
    (ARCH, 512, 4, 1e-3),           # z-loss, four chunks
    ("gemma2-27b", None, 16, 1e-4),  # softcap, tied head, one chunk
])
def test_xent_loss_matches_reference(arch, vocab, chunk, z):
    over = {} if vocab is None else {"vocab_size": vocab}
    jcfg = jget_smoke(arch).with_(dtype=jnp.float32, **over)
    tcfg = get_smoke(arch).with_(dtype=torch.float32, **over)
    vp = TL.pad_vocab(tcfg.vocab_size)
    rng = np.random.default_rng(0)
    d = tcfg.d_model
    hid = rng.standard_normal((2, 16, d)).astype(np.float32)
    w = (rng.standard_normal((vp, d) if tcfg.tie_embeddings else (d, vp)) * 0.1
         ).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) > 0.2).astype(np.float32)

    def jparams(w_):
        return {"embed": w_} if tcfg.tie_embeddings else {"lm_head": {"w": w_}}

    jb = {"labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}

    def jf(h, w_):
        return jloss.xent_loss(jparams(w_), h, jb, jcfg, JL, seq_chunk=chunk, z_loss=z)

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hid), jnp.asarray(w))
    h_t = torch.from_numpy(hid).requires_grad_(True)
    w_t = torch.from_numpy(w).requires_grad_(True)
    params = {"embed": w_t} if tcfg.tie_embeddings else {"lm_head": {"w": w_t}}
    tb = {"labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    tl, tm = xent_loss(params, h_t, tb, tcfg, TL, seq_chunk=chunk, z_loss=z)
    tl.backward()
    tl = tl.detach()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["nll"].detach()), float(jm["nll"]), rtol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"])
    for name, got, want in (("hidden", h_t.grad, jgh), ("head", w_t.grad, jgw)):
        _assert_leaf_close(got.double().numpy(), np.asarray(want, np.float64), 5e-3, name)
    # chunking changes nothing but the order of the float32 sums
    full, _ = xent_loss(params, h_t, tb, tcfg, TL, seq_chunk=16, z_loss=z)
    np.testing.assert_allclose(float(full.detach()), float(tl), rtol=1e-6)


def test_padded_vocab_columns_never_win():
    """Padded columns are masked to -1e30: a huge weight there changes
    nothing."""
    cfg = get_smoke(ARCH).with_(dtype=torch.float32, vocab_size=500)
    g = torch.Generator().manual_seed(0)
    h = torch.randn((2, 8, cfg.d_model), generator=g)
    w = torch.randn((cfg.d_model, 512), generator=g) * 0.1
    b = {"labels": torch.randint(0, 500, (2, 8), generator=g), "mask": torch.ones(2, 8)}
    base, _ = xent_loss({"lm_head": {"w": w}}, h, b, cfg, TL)
    w2 = w.clone()
    w2[:, 500:] = 1e4
    got, _ = xent_loss({"lm_head": {"w": w2}}, h, b, cfg, TL)
    assert torch.equal(got, base)


# ------------------------------------------------------------- one step

def _step_case(policy, moments="f32", ef=False, remat=False, micro=1):
    jcfg = jget_smoke(ARCH).with_(dtype=jnp.float32, quant_policy=policy, remat=remat)
    tcfg = get_smoke(ARCH).with_(dtype=torch.float32, quant_policy=policy, remat=remat)
    opt = dict(warmup_steps=1, moments_dtype=moments)
    jt = jts.TrainStepConfig(optimizer=jadamw.AdamWConfig(**opt), seq_chunk=8,
                             z_loss=1e-4, ef_compression=ef, microbatch=micro)
    tt = TrainStepConfig(optimizer=AdamWConfig(**opt), seq_chunk=8, z_loss=1e-4,
                         ef_compression=ef, microbatch=micro)
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg, JL, jt)
    return jcfg, tcfg, jt, tt, jstate


@pytest.mark.parametrize("policy,moments,ef", [
    ("f32", "f32", False), ("bf16", "f32", False), ("tnn", "f32", False),
    ("tnn", "int8", True)])
def test_one_step_matches_reference(policy, moments, ef):
    jcfg, tcfg, jt, tt, jstate = _step_case(policy, moments, ef)
    jb, tb = _batch(tcfg.vocab_size, 16, 2)
    (jl, jm), jg = jax.value_and_grad(jts.make_loss_fn(jcfg, JL, jt), has_aux=True)(
        jstate["params"], jb)
    state = _from_jax(jstate)
    (tl, tm), tg = tts.value_and_grad(tts.make_loss_fn(tcfg, TL, tt), state["params"], tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=2e-5)
    got, want = _np(tg), _np(_from_jax(jg))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        _assert_leaf_close(g, w, GRAD_TOL[policy], f"{policy} grad {k}")

    # the whole step from the same state: the reference's optimizer (and
    # EF round trip) on the port's gradients
    new_state, met = make_train_step(tcfg, TL, tt)(_from_jax(jstate), tb)
    jgrads = jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, interop.train_state_to_numpy(
        {"g": tg})["g"]))
    if ef:
        from repro.optim import compression as jcomp
        jgrads, jef = jcomp.ef_compress_update(jgrads, jstate["ef"])
        for (k, a), (_, b) in zip(_np(new_state["ef"]), _np(_from_jax(jef))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                       err_msg=k)
    jp, jo, jmet = jadamw.adamw_update(jgrads, jstate["opt"], jstate["params"], jt.optimizer)
    assert float(met["loss"]) == float(tl)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)
    for (k, a), (_, b) in zip(_np(new_state["params"]), _np(_from_jax(jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max(), err_msg=k)
    assert sorted(new_state) == sorted(["params", "opt"] + (["ef"] if ef else []))
    assert sorted(new_state["opt"]) == ["m", "step", "v"]
    assert int(new_state["opt"]["step"]) == 1


def test_remat_equals_no_remat():
    """cfg.remat checkpoints each period (and, with remat_block on a
    two-block pattern, each block): loss and gradients torch.equal to
    the forward without it."""
    tt = TrainStepConfig(seq_chunk=8)
    for arch in (ARCH, "gemma2-27b"):
        jcfg = jget_smoke(arch).with_(dtype=jnp.float32)
        params = _from_jax(jmodel_init(jcfg))
        _, tb = _batch(jcfg.vocab_size, 16, 2)
        out = {}
        for remat in (False, True):
            cfg = get_smoke(arch).with_(dtype=torch.float32, quant_policy="tnn", remat=remat)
            out[remat] = tts.value_and_grad(tts.make_loss_fn(cfg, TL, tt), params, tb)
        (l0, _), g0 = out[False]
        (l1, _), g1 = out[True]
        assert torch.equal(l0, l1), arch
        for (k, a), (_, b) in zip(flatten_with_paths(g0), flatten_with_paths(g1)):
            assert torch.equal(a, b), (arch, k)
    assert get_smoke("gemma2-27b").period > 1


def jmodel_init(jcfg):
    from repro.models import model as jmodel
    return jmodel.init_lm(jax.random.PRNGKey(1), jcfg, JL)


def test_remat_checkpoints_the_periods(monkeypatch):
    """With remat each period (and each block of a longer pattern) runs
    under torch.utils.checkpoint; without autograd nothing does."""
    from repro_torch.models import model

    calls = []
    real = model.checkpoint
    monkeypatch.setattr(model, "checkpoint",
                        lambda fn, *a, **kw: calls.append(kw) or real(fn, *a, **kw))
    cfg = get_smoke("gemma2-27b").with_(dtype=torch.float32, remat=True)
    params = model.init_lm(torch.Generator().manual_seed(0), cfg, TL, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with torch.no_grad():
        model.forward_hidden(params, batch, cfg, TL)
    assert calls == []
    model.forward_hidden(params, batch, cfg, TL)
    assert len(calls) == cfg.num_periods * (1 + cfg.period)
    assert all(kw == {"use_reentrant": False} for kw in calls)


def test_microbatch_matches_reference_and_single():
    """microbatch=2: the mean loss of the halves equals microbatch=1's to
    rtol 1e-4, and the reference's microbatch=2 loss to 2e-5."""
    jcfg, tcfg, jt, tt, jstate = _step_case("bf16", micro=2)
    jb, tb = _batch(tcfg.vocab_size, 16, 4)
    _, m2 = make_train_step(tcfg, TL, tt)(_from_jax(jstate), tb)
    _, m1 = make_train_step(tcfg, TL, dataclasses.replace(tt, microbatch=1))(
        _from_jax(jstate), tb)
    _, jm2 = jts.make_train_step(jcfg, JL, jt)(jstate, jb)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jm2["grad_norm"]), rtol=1e-3)


# ---------------------------------------------------------------- Trainer

def _mk(checkpoint_dir=None, steps=60, quant="bf16", micro=1):
    cfg = get_smoke(ARCH).with_(vocab_size=256, d_model=128, num_heads=4,
                                num_kv_heads=2, d_ff=256, quant_policy=quant)
    tcfg = TrainStepConfig(
        optimizer=AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=steps,
                              weight_decay=0.0),
        microbatch=micro, seq_chunk=32)
    source = SyntheticLM(vocab_size=256, seq_len=64, global_batch=8, noise=0.05, order=1)
    tr = TrainerConfig(steps=steps, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=20, log_every=1000)
    return cfg, tcfg, source, tr


def _trainer(cfg, tcfg, tr, source, **kw):
    return Trainer(cfg, TL, tcfg, tr, source, device="cpu", log_fn=lambda s: None, **kw)


def test_loss_decreases():
    cfg, tcfg, source, tr = _mk(steps=60)
    res = _trainer(cfg, tcfg, tr, source).run()
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.5, (first, last)
    assert last < math.log(256)


def test_qat_low_bit_trains():
    cfg, tcfg, source, tr = _mk(steps=40, quant="tnn")
    res = _trainer(cfg, tcfg, tr, source).run()
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.3


def test_checkpoint_resume_exact(tmp_path):
    """Train 12 with a save every 4; restart from step 4 after a
    simulated crash: the losses of steps 4-12 and the final state are
    torch.equal to the uninterrupted run's."""
    d = str(tmp_path / "ck")
    cfg, tcfg, source, tr = _mk(checkpoint_dir=d, steps=12, quant="tnn")
    tr = dataclasses.replace(tr, checkpoint_every=4)
    full = _trainer(cfg, tcfg, tr, source).run()
    shutil.copytree(os.path.join(d, "step_000012"), str(tmp_path / "full_12"))
    for name in os.listdir(d):
        if name != "step_000004":
            shutil.rmtree(os.path.join(d, name))
    t2 = _trainer(cfg, tcfg, tr, source)
    state, data_state = t2.restore_or_init()
    assert data_state.step == 4 and int(state["opt"]["step"]) == 4
    resumed = t2.run(state, data_state)
    assert resumed.losses == full.losses[4:]
    target = t2.restore_or_init()[0]
    os.makedirs(tmp_path / "a")
    shutil.move(str(tmp_path / "full_12"), str(tmp_path / "a" / "step_000012"))
    want, _ = restore_tree(str(tmp_path / "a"), 12, target)
    got, _ = restore_tree(d, 12, target)
    for (k, a), (_, b) in zip(flatten_with_paths(got), flatten_with_paths(want)):
        assert torch.equal(a, b), k


def test_watchdog_fires_restart_plan_after_committed_save(tmp_path, monkeypatch):
    """Two hosts, host 1 silent: the FakeClock watchdog reports it dead at
    the first check; the trainer saves step 1, waits for the commit and
    returns the elastic plan for the chips left (this process given 256
    chips, so a plan exists: the reference's for 128)."""
    class FakeClock:
        t = 0.0

        def __call__(self):
            return self.t

    monkeypatch.setattr(trainer_mod, "_chips", lambda dev: 256)
    d = str(tmp_path / "ck")
    cfg, tcfg, source, tr = _mk(checkpoint_dir=d, steps=10)
    t = _trainer(cfg, tcfg, tr, source, num_hosts=2)
    t.watchdog = Watchdog(WatchdogConfig(dead_after_s=100.0), num_hosts=2, clock=FakeClock())
    res = t.run()
    assert res.final_step == 1 and len(res.losses) == 1
    assert t.ckpt.latest_step() == 1
    assert os.path.exists(os.path.join(d, "step_000001", "MANIFEST.json"))
    assert dataclasses.asdict(res.restart_plan) == dataclasses.asdict(jplan_restart(128))
    assert (res.restart_plan.pods, res.restart_plan.data, res.restart_plan.model) == (1, 8, 16)


def test_trainer_defaults_to_cuda():
    cfg, tcfg, source, tr = _mk(steps=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TL, tcfg, tr, source)


def test_launch_train_main_cpu(capsys):
    res = launch_train.main(["--smoke", "--device", "cpu", "--quant", "tnn", "--steps", "6",
                             "--batch", "4", "--seq", "32", "--lr", "3e-3"])
    assert res.final_step == 6 and len(res.losses) == 6
    assert all(np.isfinite(res.losses))
    assert "[launch.train] done at step 6" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="need 256 devices for mesh"):
        launch_train.main(["--smoke", "--device", "cpu", "--production"])
