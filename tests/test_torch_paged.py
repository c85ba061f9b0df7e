"""The paged KV pool and the batch-invariant admission, through the engine.

The staggered trace of ``_torch_port`` through the reference ``Engine`` and
the port's with ``kv_layout="paged"``: token for token in bf16-layout pools
(plain ``decode_block=1`` and fused ``=8``) and in int8 pools, and equal to
the port's own dense engine; prefix sharing with the reference's
``paging_stats``; deferral under pool pressure; config validation; the
sentinel writes that the reference's scatter drops; and the admission of a
prompt alone and in a group of four giving bitwise-equal logits, dense and
paged. fp32 reduced configs (see ``_torch_port``).
"""
import numpy as np
import pytest
import torch

from repro.models import model as RMD
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import model as MD

from _torch_port import (no_activation_mesh,  # noqa: F401
                         engine_kwargs, model_pair, port_engine,
                         ref_engine, run_trace, trace_requests)

KV_BLOCK = 4


def _tokens(done):
    return [list(r.out_tokens) for r in done]


def _paged(**kw):
    out = engine_kwargs(**{k: kw.pop(k) for k in ("decode_block",)
                           if k in kw})
    out.update(kv_layout="paged", kv_block=KV_BLOCK, **kw)
    return out


@pytest.fixture(scope="module", params=["full", "merged"])
def paged_setup(request):
    rcfg, params, pcfg, model = model_pair(request.param)
    reqs = trace_requests(rcfg.vocab_size)
    ref = {}
    for key, kw in (("bf16", _paged()), ("int8", _paged(kv_dtype="int8"))):
        eng = ref_engine(rcfg, params, **kw)
        done = run_trace(eng, reqs)
        assert all(r.status == "ok" for r in done)
        ref[key] = (_tokens(done), dict(eng.paging_stats))
    dense = _tokens(run_trace(port_engine(pcfg, model, **engine_kwargs()),
                              reqs))
    return dict(rcfg=rcfg, params=params, pcfg=pcfg, model=model, reqs=reqs,
                ref=ref, dense=dense)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_token_for_token_vs_reference(paged_setup, kv_dtype, K):
    s = paged_setup
    eng = port_engine(s["pcfg"], s["model"],
                      **_paged(decode_block=K, kv_dtype=kv_dtype))
    done = run_trace(eng, s["reqs"])
    assert all(r.status == "ok" for r in done)
    want, want_stats = s["ref"][kv_dtype]
    assert _tokens(done) == want
    if K == 8:             # the reference ran at K=8: the same admissions
        assert eng.paging_stats == want_stats
    assert eng.kv_dtype_served == kv_dtype
    if kv_dtype == "bf16":
        assert _tokens(done) == s["dense"]         # paged bf16 == dense
    # one readback per admission group and per block
    c = eng.counters
    assert c["host_syncs"] == c["device_calls"]
    eng._alloc.check_invariants()


@pytest.fixture(scope="module")
def shared_setup():
    """Identical prompts admitted one after another (prefix sharing), and a
    pool too small for every slot at once (deferral)."""
    rcfg, params, pcfg, model = model_pair("full")
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, rcfg.vocab_size, size=14).astype(np.int32)
    other = rng.integers(1, rcfg.vocab_size, size=9).astype(np.int32)
    trace = [dict(prompt=prompt if i % 2 == 0 else other, max_new_tokens=6,
                  arrival_time=float(i * 3)) for i in range(6)]
    eng = ref_engine(rcfg, params, **_paged())
    done = run_trace(eng, trace)
    return dict(pcfg=pcfg, model=model, trace=trace, ref=_tokens(done),
                ref_stats=dict(eng.paging_stats))


def test_prefix_sharing_matches_reference_stats(shared_setup):
    s = shared_setup
    eng = port_engine(s["pcfg"], s["model"], **_paged())
    done = run_trace(eng, s["trace"])
    got = _tokens(done)
    assert got == s["ref"]
    assert eng.paging_stats == s["ref_stats"]
    assert eng.paging_stats["prefix_hits"] >= 2
    # the duplicates decode identical tokens
    assert got[0] == got[2] == got[4] and got[1] == got[3] == got[5]
    eng._alloc.check_invariants()


def test_prefix_sharing_disabled_never_hits(shared_setup):
    s = shared_setup
    eng = port_engine(s["pcfg"], s["model"], **_paged(prefix_sharing=False))
    assert _tokens(run_trace(eng, s["trace"])) == s["ref"]
    assert eng.paging_stats["prefix_hits"] == 0
    assert eng.paging_stats["free_blocks"] == eng._alloc.nb


def test_deferral_under_pool_pressure_preserves_outputs(paged_setup):
    """A pool too small for every slot at once defers admissions; every
    request still finishes with the dense engine's tokens and every block
    comes back."""
    s = paged_setup
    eng = port_engine(s["pcfg"], s["model"],
                      **_paged(kv_blocks=8, prefix_sharing=False))
    done = run_trace(eng, s["reqs"])
    assert all(r.status == "ok" for r in done)
    assert _tokens(done) == s["dense"]
    assert eng.paging_stats["deferrals"] > 0
    assert eng.paging_stats["free_blocks"] == 8
    assert any(r.deferred for r in done)


def test_deferred_request_that_expires_sheds_as_pool_pressure(paged_setup):
    s = paged_setup
    eng = port_engine(s["pcfg"], s["model"],
                      **_paged(kv_blocks=6, prefix_sharing=False))
    p = np.arange(1, 13, dtype=np.int32)
    first = eng.submit(p, max_new_tokens=12)                # 6 blocks: all
    late = eng.submit(p[:4], max_new_tokens=4, ttl=2.0)
    done = eng.run()
    assert first.status == "ok" and len(first.out_tokens) == 12
    assert late.status == "shed" and late.shed_reason == "pool_pressure"
    assert {r.uid for r in done} == {first.uid, late.uid}


def test_paged_config_validation(paged_setup):
    s = paged_setup
    with pytest.raises(ValueError, match="kv_dtype"):
        port_engine(s["pcfg"], s["model"], **engine_kwargs(), kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_layout"):
        port_engine(s["pcfg"], s["model"], **engine_kwargs(),
                    kv_layout="ring")
    with pytest.raises(ValueError, match="multiple of"):
        port_engine(s["pcfg"], s["model"],
                    **dict(engine_kwargs(), kv_layout="paged", kv_block=5))
    with pytest.raises(ValueError, match="kv_dtype"):
        port_engine(s["pcfg"], s["model"], **_paged(kv_dtype="fp8"))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sentinel_writes_land_in_the_sink_block(paged_setup, kv_dtype):
    """Decode through a table whose rows are sentinels (a released slot) or
    whose position is past ``s_max`` (a slot that filled its reservation):
    the reference's scatter drops those writes; here they must not raise
    and must leave every block an allocator could hand out untouched. With
    a pool of exactly ``n_blocks`` blocks (no sink) the same call indexes
    out of range."""
    s = paged_setup
    cfg, model = s["pcfg"], s["model"]
    nb, bs, mb = 6, KV_BLOCK, 3
    cache = MD.init_paged_cache(cfg, 3, mb * bs, "cpu", n_blocks=nb,
                                block_size=bs, kv_dtype=kv_dtype)
    for key in cache:
        if key in ("kp", "vp", "ks", "vs"):
            cache[key].copy_(torch.randn(cache[key].shape).to(
                cache[key].dtype) if cache[key].dtype != torch.int8 else
                torch.randint(-9, 9, cache[key].shape, dtype=torch.int8))
    cache["tab"][0] = torch.tensor([0, 1, 2])      # slot 0: owns 0..2, full
    cache["pos"][:] = torch.tensor([mb * bs, 3, 0], dtype=torch.int32)
    # slot 1 and 2: released (sentinel rows)
    before = {k: v.clone() for k, v in cache.items()}
    tok = torch.tensor([1, 2, 3])
    act = torch.tensor([True, True, True])
    MD.decode_step_slots(cfg, model, cache, tok, act)
    for key in [k for k in ("kp", "vp", "ks", "vs") if k in cache]:
        assert torch.equal(cache[key][:, :nb], before[key][:, :nb]), key
        assert not torch.equal(cache[key][:, nb], before[key][:, nb]), key
    assert cache["pos"].tolist() == [mb * bs + 1, 4, 1]
    # without the sink
    kp = before["kp"][0, :nb].clone()
    blk = torch.tensor([0, nb, nb])
    with pytest.raises(IndexError):
        L._paged_write(kp, None if kv_dtype == "bf16" else
                       before["ks"][0, :nb].clone(), blk,
                       torch.tensor([0, 1, 2]),
                       torch.zeros((3, cfg.n_kv_heads, cfg.hd)))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_admission_alone_and_in_a_group_of_four_bitwise(paged_setup, layout):
    """A prompt's admission logits do not depend on which other prompts
    share its admission group (each row is prefilled at batch 1)."""
    s = paged_setup
    cfg, model = s["pcfg"], s["model"]
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32))
    lengths = torch.tensor([13, 16, 5, 9], dtype=torch.int32)

    def admit(n):
        slots = np.arange(n, dtype=np.int32)
        if layout == "dense":
            cache = MD.init_slot_cache(cfg, 4, 24, "cpu")
            logits, _, cache = ST.make_slot_admit(cfg)(
                model, cache, toks[:n], lengths[:n], slots)
            return logits, cache["k"][:, 0, :13]
        cache = MD.init_paged_cache(cfg, 4, 24, "cpu", n_blocks=24,
                                    block_size=KV_BLOCK)
        cache["tab"][:4] = torch.arange(24, dtype=torch.int32).reshape(4, 6)
        logits, _, cache = ST.make_slot_admit_paged(cfg)(
            model, cache, toks[:n], lengths[:n], slots,
            torch.zeros((n,), dtype=torch.int32))
        return logits, cache["kp"][:, :4].reshape(cfg.n_layers, 16, -1)[:, :13]

    alone, kv_alone = admit(1)
    among, kv_among = admit(4)
    assert among.shape[0] == 4 and torch.equal(alone[0], among[0])
    assert torch.equal(kv_alone, kv_among)


def test_admission_step_skips_pad_rows(paged_setup):
    """The engine never pads an admission group, so the steps take no pad
    rows: a slot outside [0, n_slots) is refused before anything is computed
    or written, dense and paged; a group of real rows yields one logits row
    per row."""
    s = paged_setup
    cfg, model = s["pcfg"], s["model"]
    cache = MD.init_slot_cache(cfg, 2, 24, "cpu")
    toks = torch.ones((4, 8), dtype=torch.int32)
    lengths = torch.tensor([8, 3, 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        ST.make_slot_admit(cfg)(model, cache, toks, lengths,
                                np.array([1, 0, 2, 2], np.int32))
    assert cache["pos"].tolist() == [0, 0]
    paged = MD.init_paged_cache(cfg, 2, 24, "cpu", n_blocks=12, block_size=4)
    with pytest.raises(ValueError, match="outside"):
        ST.make_slot_admit_paged(cfg)(model, paged, toks, lengths,
                                      np.array([1, 0, 2, 2], np.int32),
                                      torch.zeros((4,), dtype=torch.int32))
    assert paged["pos"].tolist() == [0, 0]
    logits, greedy, cache = ST.make_slot_admit(cfg)(
        model, cache, toks[:2], lengths[:2], np.array([1, 0], np.int32))
    assert logits.shape[0] == 2 and greedy.shape == (2,)
    assert cache["pos"].tolist() == [3, 8]


def test_reference_paged_cache_layout_is_kept(paged_setup):
    """Table and pools as the reference lays them out, plus the sink."""
    s = paged_setup
    rcfg, cfg = s["rcfg"], s["pcfg"]
    ref = RMD.init_paged_cache(rcfg, 3, 24, n_blocks=10, block_size=4,
                               kv_dtype="int8")
    mine = MD.init_paged_cache(cfg, 3, 24, "cpu", n_blocks=10, block_size=4,
                               kv_dtype="int8")
    np.testing.assert_array_equal(mine["tab"].numpy(), np.asarray(ref["tab"]))
    for key in ("kp", "vp", "ks", "vs"):
        want = list(ref[key].shape)
        want[1] += 1
        assert list(mine[key].shape) == want
        assert str(mine[key].dtype).split(".")[-1] == str(ref[key].dtype)
    assert tuple(ref["pos"].shape) == tuple(mine["pos"].shape)
