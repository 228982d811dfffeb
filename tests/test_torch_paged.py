"""The port's paged ternary KV cache (``repro_torch.models.paged_kvcache``,
``attention.paged_attention_step``) against the JAX package's, on the CPU.

Counterparts of ``tests/test_paged_kvcache.py`` (format registry,
geometry rejects, oracle round trip, quantization error, dead tokens,
allocator and pager accounting, ``reset_pages``, ``tree_nbytes``), plus
the same functions against the reference on the same inputs.

Bounds:

* ``ternarize_tokens``, ``append_tokens``, ``page_view``: ``array_equal``
  to the reference on inputs whose per-token sums are exact in float32
  (multiples of 2**-8 below 8 in magnitude: no reduction order can round
  them); on gaussian inputs the ternary values are equal and the scales
  within 2 ULP (rtol 2.4e-7: the two frameworks sum in different orders);
* the oracle round trip and the page machinery's own error: exact;
* ``paged_attention_step`` (float32 model, decode and chunk): 1e-5;
* the sliding-window ring: the port's ``tnn2-oracle`` chunked prefill
  and decode within 1e-4 of the port's dense full prefill, whose forward
  is held to the reference's (float32 model, 1e-5 per token row with
  ``test_torch_lm``'s one-row-in-eight allowance).  The ground truth is
  the dense prefill, not the reference's own paged run, which differs
  from its dense prefill by ~1e-2 (ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import paged_kvcache as jpaged
from repro.models.kvcache import init_caches as jinit_caches
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.core.encoding import packed_width
from repro_torch.models import attention, model
from repro_torch.models import paged_kvcache as paged
from repro_torch.models.common import KV_CACHE_FORMATS, kv_cache_format
from repro_torch.models.kvcache import INVALID_POS, init_caches

from test_torch_lm import JL, TL, _layer0, assert_rows_close

CPU = "cpu"


def _kvp(cfg):
    return attention.head_layout(cfg.num_heads, cfg.num_kv_heads, TL.tp).kvp


def _strip(entry):
    return {k: v[0] for k, v in entry.items()}


def _backed(entry, batch, hi):
    """Give every slot pages for positions [0, hi) through an EntryPager."""
    pager = paged.EntryPager.from_entry(entry, batch)
    for b in range(batch):
        pager.ensure(b, hi)
    entry = dict(entry)
    entry["page_table"] = pager.device_table(1, CPU)[0]
    return entry, pager


def _pair(cfg, batch, max_len, page):
    p = _strip(paged.init_paged_caches(cfg, TL, batch, max_len, page_size=page, device=CPU)[0])
    o = _strip(paged.init_paged_caches(cfg, TL, batch, max_len, page_size=page, oracle=True,
                                       device=CPU)[0])
    return p, o


def _np_entry(entry):
    return {k: (v.numpy().view(np.uint32) if k.endswith(("plus", "minus")) else
                v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in entry.items()}


def _j_entry(entry):
    out = {}
    for k, v in _np_entry(entry).items():
        out[k] = jnp.asarray(v, jnp.bfloat16) if entry[k].dtype == torch.bfloat16 \
            else jnp.asarray(v)
    return out


# ------------------------------------------------------------ formats

def test_kv_cache_format_registry():
    assert not kv_cache_format("bf16").paged and not kv_cache_format("int8").paged
    assert kv_cache_format("tnn2").paged and kv_cache_format("tnn2").storage_dtype is None
    assert kv_cache_format("tnn2-oracle").paged
    assert kv_cache_format("tnn2-oracle").storage_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        kv_cache_format("fp4")
    for name in KV_CACHE_FORMATS:
        assert kv_cache_format(name).name == name


def test_init_paged_rejects_ssm_and_bad_geometry():
    with pytest.raises(NotImplementedError, match="SSM"):
        init_caches(get_smoke("mamba2-1.3b").with_(kv_cache_dtype="tnn2"), TL, 2, 32,
                    device=CPU)
    with pytest.raises(ValueError):
        paged.init_paged_caches(get_smoke("tinyllama-1.1b"), TL, 2, 32, page_size=0,
                                device=CPU)


@pytest.mark.parametrize("kvd", ["tnn2", "tnn2-oracle"])
def test_paged_layout_matches_reference(kvd):
    """Every leaf's name, shape and byte size as the reference builds them
    (uint32 planes are int32 here), and the logical axes cover them."""
    cfg = get_smoke("gemma2-27b").with_(kv_cache_dtype=kvd)
    caches = init_caches(cfg, TL, 3, 40, page_size=8, prefill_chunk=16, device=CPU)
    jc = jinit_caches(jget_smoke("gemma2-27b").with_(kv_cache_dtype=kvd), JL, 3, 40,
                      page_size=8, prefill_chunk=16)
    for entry, jentry, ax in zip(caches, jc, paged.paged_logical_axes(cfg)):
        assert set(entry) == set(jentry)
        for key, leaf in entry.items():
            assert tuple(leaf.shape) == tuple(jentry[key].shape), key
            assert leaf.element_size() == jnp.dtype(jentry[key].dtype).itemsize
            assert len(ax[key]) == leaf.ndim
        np.testing.assert_array_equal(entry["pos"].numpy(), np.asarray(jentry["pos"]))
    assert paged.tree_nbytes(caches) == jpaged.tree_nbytes(jc)


# ------------------------------------------------------- the quantizer

def test_ternarize_tokens_equals_reference():
    rng = np.random.default_rng(1)
    exact = (rng.integers(-2047, 2048, (3, 5, 4, 64)) / 256.0).astype(np.float32)
    gauss = rng.standard_normal((3, 5, 4, 64)).astype(np.float32)
    for x, rtol in ((exact, 0.0), (gauss, 2.4e-7)):
        t, alpha = paged.ternarize_tokens(torch.from_numpy(x))
        jt, jalpha = jpaged.ternarize_tokens(jnp.asarray(x))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        if rtol:
            np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(alpha.numpy(), np.asarray(jalpha))
    bf = torch.from_numpy(exact).to(torch.bfloat16)
    np.testing.assert_array_equal(paged.ternarize_tokens(bf)[1].numpy(),
                                  np.asarray(jpaged.ternarize_tokens(
                                      jnp.asarray(exact, jnp.bfloat16))[1]))


@pytest.mark.parametrize("oracle", [False, True])
def test_append_and_page_view_equal_reference(oracle):
    """Three calls on the same geometry and tables on both sides — a full
    chunk, a chunk with dead padding tokens and a dead row, and decode
    tokens that wrap a ring smaller than the positions: every leaf
    written and the gathered view equal to the reference's."""
    cfg = get_smoke("tinyllama-1.1b")
    kvp, dh, b = _kvp(cfg), cfg.head_dim_, 2
    rng = np.random.default_rng(2)
    entry = _strip(paged.init_paged_caches(cfg, TL, b, 24, page_size=4, oracle=oracle,
                                           device=CPU)[0])
    entry, _ = _backed(entry, b, 24)
    jentry = _j_entry(entry)
    calls = [(np.arange(8)[None].repeat(b, 0), np.ones((b, 8), bool)),
             (np.arange(8, 16)[None].repeat(b, 0),
              np.array([[True] * 5 + [False] * 3, [False] * 8])),
             (np.array([[27], [30]]), np.ones((b, 1), bool))]     # 27, 30 wrap the 24-ring
    for positions, live in calls:
        s = positions.shape[1]
        k = (rng.integers(-2047, 2048, (b, s, kvp, dh)) / 256.0).astype(np.float32)
        v = (rng.integers(-2047, 2048, (b, s, kvp, dh)) / 256.0).astype(np.float32)
        jentry = jpaged.append_tokens(jentry, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(positions, jnp.int32), jnp.asarray(live))
        out = paged.append_tokens(entry, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(positions.astype(np.int32)),
                                  torch.from_numpy(live))
        assert out is entry
        got, want = _np_entry(entry), {kk: np.asarray(vv, np.float32)
                                       if vv.dtype == jnp.bfloat16 else np.asarray(vv)
                                       for kk, vv in jentry.items()}
        for key in got:
            if key in ("pos", "page_table"):
                np.testing.assert_array_equal(got[key], want[key], key)
            else:        # the scratch page's content is whichever dead write won
                np.testing.assert_array_equal(got[key][1:], want[key][1:], key)
        kv, vv, pos = paged.page_view(entry, dh)
        jk, jv, jpos = jpaged.page_view(jentry, dh)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        live_slots = pos.numpy() != INVALID_POS
        for t, jt in ((kv, jk), (vv, jv)):
            np.testing.assert_array_equal(t.float().numpy()[live_slots],
                                          np.asarray(jt, np.float32)[live_slots])
    # row 0: 0..12, position 3's slot taken by 27; row 1: 0..7, 6's by 30
    assert ((pos.numpy() != INVALID_POS).sum(1) == [13, 8]).all()


def test_oracle_roundtrip_bit_exact():
    """Tokens in {-a, 0, +a}, a a power of two, survive quantize-at-append
    exactly: the packed view equals the oracle's and the input."""
    cfg = get_smoke("tinyllama-1.1b")
    b, s, dh, kvp = 2, 12, cfg.head_dim_, _kvp(cfg)
    packed, oracle = _pair(cfg, b, 32, page=8)
    packed, _ = _backed(packed, b, s)
    oracle, _ = _backed(oracle, b, s)
    g = torch.Generator().manual_seed(3)

    def field():
        t = torch.randint(-1, 2, (b, s, kvp, dh), generator=g)
        t[..., 0] = 1
        alpha = 2.0 ** torch.randint(-2, 2, (b, s), generator=g)
        return (t * alpha[..., None, None]).float()

    k, v = field(), field()
    positions = torch.arange(s, dtype=torch.int32).expand(b, s)
    live = torch.ones((b, s), dtype=torch.bool)
    paged.append_tokens(packed, k, v, positions, live)
    paged.append_tokens(oracle, k, v, positions, live)
    kp, vp, pos_p = paged.page_view(packed, dh)
    ko, vo, pos_o = paged.page_view(oracle, dh)
    assert torch.equal(pos_p, pos_o) and torch.equal(pos_p[:, :s], positions)
    assert (pos_p[:, s:] == INVALID_POS).all()
    assert torch.equal(kp[:, :s], ko[:, :s].float()) and torch.equal(vp[:, :s], vo[:, :s].float())
    assert torch.equal(kp[:, :s], k) and torch.equal(vp[:, :s], v)


def test_quantization_error_bounded():
    """On gaussian K/V the pages add no error to the per-token TWN
    quantizer, which beats the zero predictor."""
    cfg = get_smoke("tinyllama-1.1b")
    b, s, dh, kvp = 2, 16, cfg.head_dim_, _kvp(cfg)
    packed, _ = _pair(cfg, b, 32, page=8)
    packed, _ = _backed(packed, b, s)
    g = torch.Generator().manual_seed(4)
    k, v = (torch.randn((b, s, kvp, dh), generator=g) for _ in range(2))
    positions = torch.arange(s, dtype=torch.int32).expand(b, s)
    paged.append_tokens(packed, k, v, positions, torch.ones((b, s), dtype=torch.bool))
    kd, vd, _ = paged.page_view(packed, dh)
    for x, got in ((k, kd[:, :s]), (v, vd[:, :s])):
        t, alpha = paged.ternarize_tokens(x)
        assert torch.equal(got, t * alpha[..., None, None])
        assert torch.linalg.norm(got - x) < torch.linalg.norm(x)
        assert (alpha > 0).all()


def test_dead_tokens_route_to_scratch():
    cfg = get_smoke("tinyllama-1.1b")
    b, s, dh, kvp = 2, 8, cfg.head_dim_, _kvp(cfg)
    packed, _ = _pair(cfg, b, 32, page=8)
    packed, _ = _backed(packed, b, s)
    k = torch.randn((b, s, kvp, dh), generator=torch.Generator().manual_seed(5))
    positions = torch.arange(s, dtype=torch.int32).expand(b, s)
    live = torch.zeros((b, s), dtype=torch.bool)
    live[0] = True
    paged.append_tokens(packed, k, k, positions, live)
    _, _, pos = paged.page_view(packed, dh)
    assert (pos[1] == INVALID_POS).all()
    assert torch.equal(pos[0, :s], positions[0])
    assert (packed["pos"][paged.SCRATCH_PAGE] == INVALID_POS).all()
    fresh, _ = _pair(cfg, b, 32, page=8)
    assert (paged.page_view(fresh, dh)[2] == INVALID_POS).all()


# ------------------------------------------------------- attention

@pytest.mark.parametrize("kvd", ["tnn2", "tnn2-oracle"])
def test_paged_attention_step_matches_jax(kvd):
    """One gemma2 layer (softcap, a 6-token window): a 5-token chunk with
    rows at different starts and a dead row's padding, then per-row
    decode steps with one dead row: outputs within 1e-5, pages equal."""
    jcfg, tcfg, jp, tp, x = _layer0("gemma2-27b", kv_cache_dtype=kvd)
    b = x.shape[0]
    entry = _strip(init_caches(tcfg, TL, b, 16, page_size=4, prefill_chunk=5,
                               device=CPU)[0])
    entry, pager = _backed(entry, b, 16)
    jentry = _j_entry(entry)
    steps = [np.array([[0, 5], [3, 2]], np.int32), np.array([5, 5], np.int32),
             np.array([6, -1], np.int32), np.array([7, 6], np.int32)]
    for i, st in enumerate(steps):
        xs = x[:, :5] if st.ndim == 2 else x[:, 4 + i:5 + i]
        ref, jentry = jattn.paged_attention_step(jp["mixer"], jnp.asarray(xs), jcfg, JL,
                                                 jentry, jnp.asarray(st), window=6)
        got, entry = attention.paged_attention_step(tp["mixer"], torch.from_numpy(xs),
                                                    tcfg, TL, entry, torch.from_numpy(st),
                                                    window=6)
        live = (np.arange(xs.shape[1])[None] < st[:, 1:2]) if st.ndim == 2 else \
            (st >= 0)[:, None]
        np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(entry["pos"].numpy(), np.asarray(jentry["pos"]))
    assert pager.stats()["used"] == b * 4


def test_al_ring_window_exact_vs_full_prefill():
    """Sliding-window correctness through the page indirection: gemma2
    smoke (window 64, an "AL" and an "A" entry; bf16 model, so the bf16
    oracle pages hold K/V exactly), a 90-token prompt prefilled in 8-token
    chunks into a ``tnn2-oracle`` cache with 8-token pages, then one
    decode step: the last chunk's and the decode step's logits within
    1e-4 of the port's dense full prefill on the same weights.  The dense
    prefill itself is held to the reference's on those weights over all
    90 positions in a float32 model (1e-5 per row, one row in eight
    allowed a rounding step of the head's bf16 operands): in a bf16 model
    the two frameworks' float32 sums meet different bf16 rounding steps
    and every row drifts (up to ~5e-2 here), with or without pages."""
    jcfg = jget_smoke("gemma2-27b")
    cfg = get_smoke("gemma2-27b")
    jparams = jmodel.init_lm(jax.random.PRNGKey(1234), jcfg, JL)
    params = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    b, L, plen, chunk, page = 2, 128, 90, 8, 8
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    def dense(t):
        lg, _ = model.prefill(params, {"tokens": t},
                              init_caches(cfg, TL, b, L, dtype=torch.bfloat16, device=CPU),
                              cfg, TL)
        return lg[:, -1]

    ref_last = dense(tt)
    nxt = ref_last.argmax(-1)
    ref_dec = dense(torch.cat([tt, nxt[:, None]], 1))

    cfgp = cfg.with_(kv_cache_dtype="tnn2-oracle")
    caches = init_caches(cfgp, TL, b, L, page_size=page, prefill_chunk=chunk, device=CPU)
    pagers = paged.make_pagers(caches, b)
    for start in range(0, plen, chunk):
        n = min(chunk, plen - start)
        tk = torch.zeros((b, chunk), dtype=torch.long)
        tk[:, :n] = tt[:, start:start + n]
        for slot in range(b):
            for pg in pagers:
                pg.ensure(slot, start + n)
        caches = paged.sync_page_tables(caches, pagers)
        st = torch.tensor([[start, n]] * b, dtype=torch.int32)
        lg, caches = model.decode_step(params, {"tokens": tk}, caches, st, cfgp, TL)
    paged_last = lg[:, n - 1]
    for slot in range(b):
        for pg in pagers:
            pg.ensure(slot, plen + 1)
    caches = paged.sync_page_tables(caches, pagers)
    lg2, _ = model.decode_step(params, {"tokens": nxt[:, None]}, caches,
                               torch.full((b,), plen, dtype=torch.int32), cfgp, TL)
    assert (paged_last - ref_last).abs().max() <= 1e-4
    assert (lg2[:, 0] - ref_dec).abs().max() <= 1e-4
    n_pages, page_sz, npp = paged.entry_geometry(caches[0])
    assert npp * page_sz < plen                      # the AL ring is smaller than the prompt

    jf32, tf32 = jcfg.with_(dtype=jnp.float32), cfg.with_(dtype=torch.float32)
    jl = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)}, jf32, JL)[0]
    tl = model.forward(params, {"tokens": tt}, tf32, TL)[0]
    assert_rows_close(tl, jl, 1e-5, "dense f32 forward over the window vs reference")


# ------------------------------------------------------- accounting

def test_page_allocator_accounting():
    alloc = paged.PageAllocator(5)
    assert (alloc.n_free, alloc.n_used) == (4, 0)
    got = alloc.alloc(3)
    assert sorted(got) == [1, 2, 3] and (alloc.n_free, alloc.n_used) == (1, 3)
    with pytest.raises(paged.PagePoolExhausted, match="exhausted"):
        alloc.alloc(2)
    alloc.free(got[:2])
    assert (alloc.n_free, alloc.n_used) == (3, 1)
    with pytest.raises(RuntimeError, match="free"):
        alloc.free([got[0]])
    with pytest.raises(RuntimeError, match="free"):
        alloc.free([4])
    alloc.free([got[2]])
    assert (alloc.n_free, alloc.n_used, alloc.high_water) == (4, 0, 3)


def test_entry_pager_ring_cap_and_release():
    pager = paged.EntryPager(num_slots=2, npp=3, page=4, n_pages=7)
    pager.ensure(0, 5)
    assert len(pager.owned[0]) == 2
    pager.ensure(0, 100)
    assert len(pager.owned[0]) == 3
    pager.ensure(1, 12)
    assert pager.alloc.n_used == 6 and pager.dirty
    table = pager.device_table(2, CPU)
    assert table.shape == (2, 2, 3) and table.dtype == torch.int32 and not pager.dirty
    assert torch.equal(table[0], table[1]) and (table > 0).all()
    freed = pager.release(0)
    assert len(freed) == 3 and pager.dirty and (pager.table[0] == 0).all()
    assert pager.alloc.n_used == 3
    pager.release(1)
    assert (pager.alloc.n_used, pager.alloc.n_free) == (0, 6)
    assert pager.release(0) == []
    assert pager.stats() == {"total": 6, "used": 0, "free": 6, "high_water": 6}


def test_sync_and_reset_pages():
    cfg = get_smoke("tinyllama-1.1b").with_(kv_cache_dtype="tnn2")
    caches = init_caches(cfg, TL, 2, 16, page_size=8, device=CPU)
    pagers = paged.make_pagers(caches, 2)
    pagers[0].ensure(1, 9)
    out = paged.sync_page_tables(caches, pagers)
    assert out[0] is caches[0]                               # written in place
    assert caches[0]["page_table"][:, 1].tolist() == [[1, 2]] * cfg.num_periods
    assert (caches[0]["page_table"][:, 0] == 0).all()
    entry = caches[0]
    entry["pos"][:, 2] = 0
    assert paged.reset_pages(entry, [2]) is entry
    assert (entry["pos"][:, 2] == INVALID_POS).all()
    assert paged.reset_pages(entry, []) is entry


def test_tree_nbytes_counts_packed_vs_dense():
    cfg = get_smoke("tinyllama-1.1b")
    packed = init_caches(cfg.with_(kv_cache_dtype="tnn2"), TL, 4, 64, device=CPU)
    dense = init_caches(cfg, TL, 4, 64, dtype=torch.bfloat16, device=CPU)
    assert paged.tree_nbytes(packed) < paged.tree_nbytes(dense)
    assert packed_width(cfg.head_dim_) == -(-cfg.head_dim_ // 32)
    jpk = jinit_caches(jget_smoke("tinyllama-1.1b").with_(kv_cache_dtype="tnn2"), JL, 4, 64)
    assert paged.tree_nbytes(packed) == jpaged.tree_nbytes(jpk)
