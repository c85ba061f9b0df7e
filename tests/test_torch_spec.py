"""Self-speculative decoding in the port (``serving/spec.py``, the verify
forward, the engine's spec mode, the graphed round), against the reference
and against the port's own plain decode.

What is held, and in which precision:

* ``accept_drafts``: the reference's rule exactly, on the reference test's
  cases and on a seeded random sweep (integer logic, no tolerance).
* ``verify_step_slots`` against the reference's: fp32 reduced configs (the
  two frameworks' products sum in other orders), the logits to the model
  tests' tolerance, dense cache, paged pool in bf16 and int8 and the split
  (merged) model.
* A verify row is a decode row: the port's verify logits and K/V rows are
  BITWISE the port's decode steps fed the same tokens, in bf16 and fp32,
  every layout; so is a dense cache with lookahead rows against one
  without.
* The engines: the port's spec engine gives the reference spec engine's
  tokens (fp32: a near-tie could flip a token across frameworks; the
  reference test's shape, MergeMoE draft greedy and at T 0.7, a random
  draft, dense and paged) and the port's plain engine's (bf16: bitwise
  within the port; every layout, three drafts, both temperatures); the
  self-draft accepts everything; the headroom check and the reservation;
  the two caches in lockstep and the full model's rows equal to plain
  decode's.
* The graphed round (``steps.GraphedRound`` under the stand-in graph of
  ``test_torch_graph_steps``) against the eager round, bitwise, with no
  host read in the round's body, and the launches credited per replay.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as RCMP
from repro.models import model as RMD
from repro.serving import accept_drafts as ref_accept_drafts
from repro_torch import configs, convert
from repro_torch.core import threefry as TF
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.serving import Engine, EngineConfig, accept_drafts
from repro_torch.serving import poisson_trace

from _torch_port import (no_activation_mesh, one_torch_thread,  # noqa: F401
                         ARCH, cfg_pair, model_pair, ref_engine,
                         ref_tree_numpy)
from test_torch_graph_steps import (counting,  # noqa: F401
                                    NullGraph, ReplayGraph, no_host_reads,
                                    static_buffers)

LENS = (5, 16, 9, 30, 12, 7)          # the reference test's trace
SPEC_K = 3
ENGINE = dict(arch=ARCH, n_slots=2, s_max=64, prefill_buckets=(8, 16, 32))
PAGED = dict(kv_layout="paged", kv_block=8)
PAGED_INT8 = dict(PAGED, kv_dtype="int8")
LAYOUTS = {"dense": {}, "paged": PAGED, "paged_int8": PAGED_INT8}


# ---------------------------------------------------------------------------
# accept_drafts
# ---------------------------------------------------------------------------

ACCEPT_CASES = {   # the reference test's cases: drafts, verify, keywords
    "all_rejected": ([1, 2, 3, 4], [9, 8, 7, 6, 5], {}),
    "all_accepted": ([1, 2, 3, 4], [1, 2, 3, 4, 9], {}),
    "partial_prefix": ([1, 2, 3, 4], [1, 2, 9, 9, 9], {}),
    "eos_inside_prefix": ([1, 2, 3, 4], [1, 2, 3, 4, 9], dict(eos=2)),
    "budget": ([1, 2, 3, 4], [1, 2, 3, 4, 9], dict(remaining=2)),
    "inactive": ([1, 2, 3, 4], [1, 2, 3, 4, 9], dict(active=False)),
    "eos_disabled": ([0, 0, 0, 0], [0, 0, 0, 0, 0], dict(eos=-1)),
}


def _both_accept(drafts, verify, active, remaining, eos, k):
    """(port, reference) outputs of accept_drafts as numpy arrays."""
    got = accept_drafts(torch.from_numpy(drafts), torch.from_numpy(verify),
                        torch.from_numpy(active), torch.from_numpy(remaining),
                        torch.from_numpy(eos), k)
    want = ref_accept_drafts(jnp.asarray(drafts), jnp.asarray(verify),
                             jnp.asarray(active), jnp.asarray(remaining),
                             jnp.asarray(eos), k)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", sorted(ACCEPT_CASES))
def test_accept_drafts_reference_cases(case):
    drafts, verify, kw = ACCEPT_CASES[case]
    args = {**dict(active=True, remaining=99, eos=-1), **kw}
    got, want = _both_accept(
        np.array([drafts], np.int32), np.array([verify], np.int32),
        np.array([args["active"]]), np.array([args["remaining"]], np.int32),
        np.array([args["eos"]], np.int32), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == np.int32 and got[0].dtype == bool


@pytest.mark.parametrize("k", [1, 3, 4])
def test_accept_drafts_random_sweep(k):
    """Random rows over a small vocabulary (so drafts match often), eos on
    and off, budgets from 0 to past K, active and not."""
    rng = np.random.default_rng(k)
    n = 512
    drafts = rng.integers(0, 3, (n, k)).astype(np.int32)
    verify = rng.integers(0, 3, (n, k + 1)).astype(np.int32)
    active = rng.random(n) < 0.8
    remaining = rng.integers(0, k + 3, n).astype(np.int32)
    eos = rng.integers(-1, 3, n).astype(np.int32)
    got, want = _both_accept(drafts, verify, active, remaining, eos, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------

def _close(got, want):
    want = np.asarray(want)
    # fp32, reduction order only, atol scaled to the logits
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


N_SLOTS, S_MAX, BS, T = 3, 24, 4, 4


def _ref_and_port_caches(rcfg, params, pcfg, model, layout):
    """Both frameworks' caches of N_SLOTS slots with three prompts
    admitted (lengths 8, 5, 3)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (N_SLOTS, 8)).astype(np.int32)
    lengths = np.array([8, 5, 3], np.int32)
    slots = np.arange(N_SLOTS, dtype=np.int32)
    if layout == "dense":
        rc = RMD.init_slot_cache(rcfg, N_SLOTS, S_MAX)
        _, rk, rv = RMD.prefill_slots(rcfg, params, jnp.asarray(toks),
                                      jnp.asarray(lengths))
        rc = RMD.insert_slots(rc, jnp.asarray(slots), rk, rv,
                              jnp.asarray(lengths))
        pc = MD.init_slot_cache(pcfg, N_SLOTS, S_MAX, "cpu", block_size=BS)
        ST.make_slot_admit(pcfg)(model, pc, torch.from_numpy(toks),
                                 torch.from_numpy(lengths), slots)
        return rc, pc
    kv = "int8" if layout == "paged_int8" else "bf16"
    nb = N_SLOTS * S_MAX // BS
    tab = np.full((N_SLOTS + 1, S_MAX // BS), nb, np.int32)
    tab[:N_SLOTS] = np.arange(nb).reshape(N_SLOTS, -1)
    rc = RMD.init_paged_cache(rcfg, N_SLOTS, S_MAX, n_blocks=nb,
                              block_size=BS, kv_dtype=kv)
    rc["tab"] = jnp.asarray(tab)
    _, rc = RMD.admit_slots_paged(rcfg, params, rc, jnp.asarray(toks),
                                  jnp.asarray(lengths), jnp.asarray(slots),
                                  jnp.zeros((N_SLOTS,), jnp.int32))
    pc = MD.init_paged_cache(pcfg, N_SLOTS, S_MAX, "cpu", n_blocks=nb,
                             block_size=BS, kv_dtype=kv)
    pc["tab"].copy_(torch.from_numpy(tab))
    ST.make_slot_admit_paged(pcfg)(model, pc, torch.from_numpy(toks),
                                   torch.from_numpy(lengths), slots,
                                   torch.zeros((N_SLOTS,), dtype=torch.int32))
    return rc, pc


@pytest.mark.parametrize("layout,kind", [("dense", "full"),
                                         ("paged", "full"),
                                         ("paged_int8", "full"),
                                         ("dense", "merged")])
def test_verify_logits_vs_reference(layout, kind):
    """fp32: ``verify_step_slots`` logits against the reference's
    (``merged``: the split model, ``stack`` then ``stack_c``), and ``pos``
    not advanced."""
    rcfg, params, pcfg, model = model_pair(kind)
    rc, pc = _ref_and_port_caches(rcfg, params, pcfg, model, layout)
    vt = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (N_SLOTS, T)).astype(np.int32)
    rlog, _ = RMD.verify_step_slots(rcfg, params, rc, jnp.asarray(vt))
    plog, out = MD.verify_step_slots(pcfg, model, pc, torch.from_numpy(vt))
    assert out is pc and plog.shape == (N_SLOTS, T, rcfg.vocab_size)
    _close(plog, rlog)
    assert pc["pos"].tolist() == [8, 5, 3]


def _bitwise_setup(dtype, layout, lookahead=0, kind="full"):
    cfg = configs.get(ARCH).reduced().replace(dtype=dtype)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="gather"))
    if kind == "merged":
        cfg = cfg.compressed(4, split=1)
    model = MD.init(cfg, "cpu", seed=0)
    if layout == "dense":
        cache = MD.init_slot_cache(cfg, N_SLOTS, S_MAX, "cpu", block_size=BS,
                                   lookahead=lookahead)
        extra, admit = (), ST.make_slot_admit(cfg)
    else:
        nb = N_SLOTS * S_MAX // BS
        cache = MD.init_paged_cache(
            cfg, N_SLOTS, S_MAX, "cpu", n_blocks=nb, block_size=BS,
            kv_dtype="int8" if layout == "paged_int8" else "bf16")
        cache["tab"][:N_SLOTS] = torch.arange(
            nb, dtype=torch.int32).reshape(N_SLOTS, -1)
        extra = (torch.zeros((N_SLOTS,), dtype=torch.int32),)
        admit = ST.make_slot_admit_paged(cfg)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (N_SLOTS, 16))
                            .astype(np.int32))
    admit(model, cache, toks, torch.tensor([16, 5, 11], dtype=torch.int32),
          np.arange(N_SLOTS, dtype=np.int32), *extra)
    vt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (N_SLOTS, T + 1))
                          .astype(np.int32))
    return cfg, model, cache, vt


def _decode_rows(cfg, model, cache, vt):
    act = torch.ones((N_SLOTS,), dtype=torch.bool)
    return torch.stack([MD.decode_step_slots(cfg, model, cache, vt[:, t],
                                             act)[0]
                        for t in range(vt.shape[1])], dim=1)


def _pools_equal(a, b):
    """Two caches bitwise but ``pos`` (a verify leaves it) and a pool's
    sink block."""
    for name in a:
        if name == "pos":
            continue
        x, y = a[name], b[name]
        if name in ("kp", "vp", "ks", "vs"):
            x, y = x[:, :-1], y[:, :-1]
        assert torch.equal(x, y), name


@pytest.mark.parametrize("kind", ["full", "merged"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_verify_rows_are_decode_rows_bitwise(dtype, layout, kind):
    """The contract of the round: the verify's logits at every position
    and the K/V rows it writes are bitwise what T + 1 decode steps compute
    when fed the same tokens (the decode steps advance ``pos``; the verify
    does not)."""
    cfg, model, cache, vt = _bitwise_setup(dtype, layout, kind=kind)
    dec = ST._clone_cache(cache)
    vlog, _ = MD.verify_step_slots(cfg, model, cache, vt)
    dlog = _decode_rows(cfg, model, dec, vt)
    assert torch.equal(vlog, dlog)
    _pools_equal(cache, dec)
    assert torch.equal(cache["pos"] + T + 1, dec["pos"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lookahead_rows_leave_decode_bitwise(dtype):
    """A spec engine's dense cache has spare rows past s_max; its decode
    table covers the first s_max rows only, so decode is bitwise the plain
    cache's, and a verify into it too."""
    cfg, model, plain, vt = _bitwise_setup(dtype, "dense")
    _, _, spare, _ = _bitwise_setup(dtype, "dense", lookahead=SPEC_K + 1)
    assert spare["k"].shape[2] > plain["k"].shape[2]
    want = _decode_rows(cfg, model, plain, vt)
    assert torch.equal(MD.verify_step_slots(cfg, model, spare, vt)[0], want)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(11)
    return ([rng.integers(0, vocab, size=n, dtype=np.int32) for n in LENS],
            poisson_trace(len(LENS), rate=0.4, seed=13))


def _serve(engine, prompts, arrivals):
    for i, (p, a) in enumerate(zip(prompts, arrivals)):
        engine.submit(p, max_new_tokens=6 + 2 * (i % 4),
                      arrival_time=float(a), uid=i)
    return {r.uid: list(r.out_tokens) for r in engine.run()}, engine


@pytest.fixture(scope="module")
def ref_setup():
    """fp32 reduced qwen3-moe in both frameworks: the model, a MergeMoE
    draft compressed by the reference (M = 4, split 0) and an unrelated
    random draft, with the reference test's trace."""
    rcfg, pcfg = cfg_pair("full")
    params = RMD.init(rcfg, jax.random.PRNGKey(0))
    calib = [{"tokens": jax.random.randint(jax.random.PRNGKey(7), (4, 64), 0,
                                           rcfg.vocab_size)}]
    rnc, rnp, _ = RCMP.compress_model(rcfg, params, method="mergemoe",
                                      merged_experts=4, split=0,
                                      batches=calib)
    adv = RMD.init(rcfg, jax.random.PRNGKey(5))
    pnc = pcfg.compressed(4, split=0)

    def port(p, c):
        return convert.from_reference_params(ref_tree_numpy(p), c, "cpu")
    return dict(rcfg=rcfg, pcfg=pcfg, params=params, model=port(params, pcfg),
                drafts={"mergemoe": ((rnc, rnp), (pnc, port(rnp, pnc))),
                        "adversarial": ((rcfg, adv), (pcfg, port(adv, pcfg)))},
                trace=_prompts(rcfg.vocab_size))


REF_FORMS = {   # (draft, temperature, layout)
    "mergemoe_greedy_dense": ("mergemoe", 0.0, "dense"),
    "mergemoe_t0.7_dense": ("mergemoe", 0.7, "dense"),
    "adversarial_greedy_dense": ("adversarial", 0.0, "dense"),
    "mergemoe_greedy_paged": ("mergemoe", 0.0, "paged"),
}


@pytest.mark.parametrize("form", sorted(REF_FORMS))
def test_spec_engine_equals_the_reference_spec_engine(ref_setup, form):
    """fp32: the port's spec engine gives the reference spec engine's
    tokens on the reference test's trace (2 slots, s_max 64, spec_k 3)."""
    name, temperature, layout = REF_FORMS[form]
    s = ref_setup
    (rdc, rdp), (pdc, pdm) = s["drafts"][name]
    kw = dict(ENGINE, spec_k=SPEC_K, temperature=temperature,
              dispatch="gather", **LAYOUTS[layout])
    want, ref = _serve(ref_engine(s["rcfg"], s["params"], (rdc, rdp), **kw),
                       *s["trace"])
    got, eng = _serve(Engine(EngineConfig(**kw), cfg=s["pcfg"],
                             params=s["model"], draft_cfg=pdc,
                             draft_params=pdm, device="cpu"), *s["trace"])
    assert got == want
    assert eng.counters["tokens_drafted"] > 0
    for key in ("tokens_drafted", "tokens_accepted", "tokens_rolled_back",
                "tokens_out"):
        assert eng.counters[key] == ref.counters[key], key
    if name == "adversarial":
        assert eng.acceptance_rate < 0.25
        assert eng.counters["tokens_rolled_back"] > 0



@pytest.fixture(scope="module")
def port_setup():
    """bf16 reduced qwen3-moe (bitwise within the port): the model, three
    drafts (a merged-shape model, M = 4 on layer 1; an unrelated random
    model; the model itself), the trace."""
    cfg = configs.get(ARCH).reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="gather"))
    model = MD.init(cfg, "cpu", seed=0)
    ncfg = cfg.compressed(4, split=1)
    return dict(cfg=cfg, model=model, trace=_prompts(cfg.vocab_size),
                drafts={"merged": (ncfg, MD.init(ncfg, "cpu", seed=3)),
                        "adversarial": (cfg, MD.init(cfg, "cpu", seed=5)),
                        "self": (cfg, model)}, plain={})


def _port_serve(s, draft=None, **kw):
    kw = dict(ENGINE, **kw)
    if draft is not None:
        kw["spec_k"] = SPEC_K
    return _serve(Engine(EngineConfig(**kw), cfg=s["cfg"], params=s["model"],
                         draft_cfg=draft[0] if draft else None,
                         draft_params=draft[1] if draft else None,
                         device="cpu"), *s["trace"])


def _plain(s, temperature, layout):
    key = (temperature, layout)
    if key not in s["plain"]:
        s["plain"][key] = _port_serve(s, temperature=temperature,
                                      **LAYOUTS[layout])[0]
    return s["plain"][key]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("draft", ["merged", "adversarial", "self"])
def test_spec_engine_equals_the_plain_engine(port_setup, draft, layout,
                                             temperature):
    s = port_setup
    got, eng = _port_serve(s, s["drafts"][draft], temperature=temperature,
                           **LAYOUTS[layout])
    assert got == _plain(s, temperature, layout)
    c = eng.counters
    assert c["tokens_drafted"] > 0 and c["host_syncs"] == c["device_calls"]
    assert c["tokens_drafted"] == c["tokens_accepted"] + \
        c["tokens_rolled_back"]
    if draft == "self":
        assert eng.acceptance_rate == 1.0 and c["tokens_rolled_back"] == 0
    # the two caches in lockstep
    assert torch.equal(eng.cache["pos"], eng.cache_draft["pos"])
    if layout != "dense":
        assert torch.equal(eng.cache["tab"], eng.cache_draft["tab"])
        eng._alloc.check_invariants()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_committed_rows_equal_plain_decode(port_setup, layout):
    """Two requests admitted together into two slots, served by the plain
    engine and by the spec engine with the random draft (every round rolls
    back): after each, ``pos`` and every committed K/V row of the full
    model's cache are the same bitwise, and the draft cache's ``pos`` is
    the full cache's."""
    s = port_setup
    prompts = [p for p in s["trace"][0][:2]]
    caches = []
    for draft in (None, s["drafts"]["adversarial"]):
        kw = dict(ENGINE, **LAYOUTS[layout])
        if draft is not None:
            kw["spec_k"] = SPEC_K
        eng = Engine(EngineConfig(**kw), cfg=s["cfg"], params=s["model"],
                     draft_cfg=draft and draft[0],
                     draft_params=draft and draft[1], device="cpu")
        for p in prompts:
            eng.submit(p, max_new_tokens=13)
        eng.run()
        if draft is not None:
            assert torch.equal(eng.cache["pos"], eng.cache_draft["pos"])
            assert eng.counters["tokens_rolled_back"] > 0
        caches.append(eng.cache)
    plain, spec = caches
    assert torch.equal(plain["pos"], spec["pos"])
    pos = plain["pos"].tolist()
    for b, n in enumerate(pos):
        if layout == "dense":
            for name in ("k", "v"):
                assert torch.equal(plain[name][:, b, :n], spec[name][:, b, :n])
        else:
            # each slot's rows through its own table: blocks may differ
            bs = PAGED["kv_block"]
            for name in [n_ for n_ in ("kp", "vp", "ks", "vs") if n_ in plain]:
                for r in range(n):
                    bp = int(plain["tab"][b, r // bs])
                    bsp = int(spec["tab"][b, r // bs])
                    assert torch.equal(plain[name][:, bp, r % bs],
                                       spec[name][:, bsp, r % bs]), (name, r)


def test_headroom_check_and_reservation_as_the_reference(port_setup):
    s = port_setup
    ncfg, nmodel = s["drafts"]["merged"]
    kw = dict(arch=ARCH, n_slots=1, s_max=32, prefill_buckets=(16,),
              spec_k=SPEC_K)
    eng = Engine(EngineConfig(**kw), cfg=s["cfg"], params=s["model"],
                 draft_cfg=ncfg, draft_params=nmodel, device="cpu")
    bound = 32 + 1 - SPEC_K - 16
    eng.submit(np.ones(16, np.int32), max_new_tokens=bound)
    with pytest.raises(ValueError, match="lookahead headroom"):
        eng.submit(np.ones(16, np.int32), max_new_tokens=bound + 1)
    done = eng.run()
    assert len(done) == 1 and len(done[0].out_tokens) == bound
    plain = Engine(EngineConfig(**dict(kw, spec_k=4)), cfg=s["cfg"],
                   params=s["model"], device="cpu")
    plain.submit(np.ones(16, np.int32), max_new_tokens=bound + 1)
    assert eng._reserve_rows(done[0]) == 16 + bound - 1 + SPEC_K
    assert plain._reserve_rows(done[0]) == 16 + bound - 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_reservation_equals_the_reference(ref_setup, layout):
    """The rows a spec engine reserves for a request, and the requests it
    rejects at the headroom bound, are the reference spec engine's."""
    s = ref_setup
    (rdc, rdp), (pdc, pdm) = s["drafts"]["mergemoe"]
    kw = dict(arch=ARCH, n_slots=1, s_max=32, prefill_buckets=(16,),
              spec_k=SPEC_K, **LAYOUTS[layout])
    ref = ref_engine(s["rcfg"], s["params"], (rdc, rdp), **kw)
    port = Engine(EngineConfig(**kw), cfg=s["pcfg"], params=s["model"],
                  draft_cfg=pdc, draft_params=pdm, device="cpu")
    for new in range(1, 20):
        outcomes = []
        for eng in (ref, port):
            try:
                req = eng.submit(np.ones(16, np.int32), max_new_tokens=new)
            except ValueError as e:
                outcomes.append(("rejected", "lookahead headroom" in str(e)))
            else:
                outcomes.append(("reserved", eng._reserve_rows(req)))
                eng._pending.clear()
                eng._inflight.clear()
        assert outcomes[0] == outcomes[1], new


# ---------------------------------------------------------------------------
# the graphed round, and the engine's spec configuration
# ---------------------------------------------------------------------------

def _admitted_pair(s, layout):
    """The model's and the merged draft's caches, three slots, the first
    two holding prompts; the round's inputs."""
    cfg, model = s["cfg"], s["model"]
    dcfg, dmodel = s["drafts"]["merged"]
    n, s_max = 3, 32
    caches = []
    for c, m in ((cfg, model), (dcfg, dmodel)):
        if layout == "dense":
            cache = MD.init_slot_cache(c, n, s_max, "cpu", block_size=8,
                                       lookahead=SPEC_K + 1)
            admit, extra = ST.make_slot_admit(c), ()
        else:
            nb = n * s_max // 8
            cache = MD.init_paged_cache(
                c, n, s_max, "cpu", n_blocks=nb, block_size=8,
                kv_dtype="int8" if layout == "paged_int8" else "bf16")
            cache["tab"][:n] = torch.arange(nb, dtype=torch.int32).reshape(
                n, -1)
            admit = ST.make_slot_admit_paged(c)
            extra = (torch.zeros((2,), dtype=torch.int32),)
        toks = torch.from_numpy(np.stack([p[:5] for p in s["trace"][0][:2]]))
        admit(m, cache, toks, torch.tensor([5, 5], dtype=torch.int32),
              np.arange(2, dtype=np.int32), *extra)
        caches.append(cache)
    keys = TF.fold_in(TF.prng_key(1), torch.tensor([3, 7, 11]))
    vals = (torch.tensor([1, 2, 0], dtype=torch.int32),
            torch.tensor([True, True, False]),
            torch.tensor([9, 2, 9], dtype=torch.int32),
            torch.full((n,), -1, dtype=torch.int32), keys)
    return caches, vals


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_graphed_round_equals_the_eager_round(port_setup, layout,
                                              temperature):
    """``steps.GraphedRound`` under the stand-in graph (capture on scratch
    copies of both caches, replay on the live ones) against the eager round
    on copies: every round's block and active flags, and both caches after
    it, bitwise, over three rounds; no host read inside the round."""
    s = port_setup
    cfg, model = s["cfg"], s["model"]
    dcfg, dmodel = s["drafts"]["merged"]
    (cache, dcache), vals = _admitted_pair(s, layout)
    e_cache, e_dcache = ST._clone_cache((cache, dcache))
    body = ST.make_slot_decode_spec(
        cfg, dcfg, SPEC_K, temperature, MD.slot_consts(cfg, cache),
        MD.slot_consts(dcfg, dcache))
    with no_host_reads():
        body(model, dmodel, *ST._clone_cache((cache, dcache)), *vals)
    graphed = ST.GraphedRound(body, model, dmodel, cache, dcache,
                              static_buffers(vals), ReplayGraph)
    ptrs = [t.data_ptr() for c in (cache, dcache) for t in c.values()]
    token = vals[0]
    for _ in range(3):
        args = (token,) + vals[1:]
        g_block, g_act, g_c, g_dc = graphed(model, dmodel, cache, dcache,
                                            *args)
        e_block, e_act, _, _ = body(model, dmodel, e_cache, e_dcache, *args)
        assert g_c is cache and g_dc is dcache
        assert torch.equal(g_block, e_block) and torch.equal(g_act, e_act)
        _pools_equal(cache, e_cache)
        _pools_equal(dcache, e_dcache)
        assert torch.equal(cache["pos"], e_cache["pos"])
        assert torch.equal(dcache["pos"], cache["pos"])
        emitted = g_block[:SPEC_K, :, 1].bool()
        last = emitted.sum(0).clamp(min=1) - 1
        token = torch.where(emitted.any(0), g_block[last, torch.arange(3), 0],
                            token)
    assert graphed.graphs["spec round"].replays == 3
    assert ptrs == [t.data_ptr() for c in (cache, dcache) for t in c.values()]
    with pytest.raises(ValueError, match="built for"):
        graphed(model, dmodel, dcache, cache, *vals)


def test_replayed_round_credits_the_eager_launches(port_setup, counting):
    """One replay of the round credits exactly the launches of an eager
    round (the draft's gather and paged launches, the verify's one grouped
    and one paged launch per layer), and warm-up and capture none."""
    s = port_setup
    cfg, model = s["cfg"], s["model"]
    dcfg, dmodel = s["drafts"]["merged"]
    (cache, dcache), vals = _admitted_pair(s, "dense")
    body = ST.make_slot_decode_spec(cfg, dcfg, SPEC_K)
    ops.reset_launch_counts()
    body(model, dmodel, *ST._clone_cache((cache, dcache)), *vals)
    eager = ops.route_launch_counts()
    assert ops.launch_counts()["grouped_swiglu"] == cfg.n_layers
    assert ops.launch_counts()["gather_swiglu"] == SPEC_K * dcfg.n_layers
    assert ops.launch_counts()["paged_attention"] == \
        SPEC_K * dcfg.n_layers + cfg.n_layers
    ops.reset_launch_counts()
    graphed = ST.GraphedRound(body, model, dmodel, cache, dcache,
                              static_buffers(vals), NullGraph)
    graphed(model, dmodel, cache, dcache, *vals)
    graphed(model, dmodel, cache, dcache, *vals)
    assert ops.route_launch_counts() == {
        n: {r: 2 * c for r, c in by_route.items()}
        for n, by_route in eager.items()}


@pytest.mark.parametrize("layout", ["dense", "paged_int8"])
def test_graph_engine_spec_equals_the_eager_engine(port_setup, monkeypatch,
                                                   layout):
    """The engine on its graph path (``Engine._graph_maker`` patched to the
    stand-in): the round and both models' admissions are graphed, each
    round is one replay, and the tokens are the plain engine's."""
    s = port_setup
    monkeypatch.setattr(Engine, "_graph_maker",
                        lambda self: (lambda pool: ReplayGraph()))
    got, eng = _port_serve(s, s["drafts"]["merged"], temperature=0.7,
                           **LAYOUTS[layout])
    assert got == _plain(s, 0.7, layout)
    stats = eng.graph_stats()
    assert isinstance(eng._decode_spec, ST.GraphedRound)
    assert stats["spec round"]["replays"] == eng.counters["device_calls"] - \
        sum(v["replays"] for k, v in stats.items() if k.startswith("admit ")
            and not k.startswith("admit draft"))
    full = sum(v["replays"] for k, v in stats.items()
               if k.startswith("admit ") and not k.startswith("admit draft"))
    draft = sum(v["replays"] for k, v in stats.items()
                if k.startswith("admit draft "))
    assert full == draft == len(LENS)


def test_spec_configuration_is_checked(port_setup):
    s = port_setup
    cfg, model = s["cfg"], s["model"]
    ncfg, nmodel = s["drafts"]["merged"]
    # a draft directory is loaded (tests/test_torch_ckpt.py): a missing one
    # raises as the reference's load does
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        Engine(EngineConfig(**dict(ENGINE, spec_draft="/x")), cfg=cfg,
               params=model, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        Engine(EngineConfig(**dict(ENGINE, spec_k=0)), cfg=cfg, params=model,
               draft_cfg=ncfg, draft_params=nmodel, device="cpu")
    with pytest.raises(ValueError, match="draft_cfg"):
        Engine(EngineConfig(**ENGINE), cfg=cfg, params=model,
               draft_params=nmodel, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        Engine(EngineConfig(**ENGINE), cfg=cfg, params=model,
               draft_cfg=ncfg.replace(vocab_size=cfg.vocab_size + 1),
               draft_params=nmodel, device="cpu")
    eng = Engine(EngineConfig(**ENGINE), cfg=cfg, params=model, device="cpu")
    assert not eng.spec and eng.cache_draft is None
    assert eng.acceptance_rate == 0.0
