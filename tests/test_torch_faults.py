"""Fault injection and the engine's resilience, the port against the reference
(``repro/serving/faults.py``, ``repro/serving/engine.py``'s §12 hooks).

* ``serving/faults.py`` is the port's own copy: for the same seed and specs
  every decision (the poison masks, transient failure counts, exhaustion,
  the corrupted bytes), the fired-fault trace and its ``trace_digest`` equal
  the reference's, over a grid of seeds and plans.
* The engine against a live reference engine (built through
  ``_torch_port.ref_engine``) on the same plan, reduced qwen3-moe in fp32:
  tokens, statuses (with finish and shed reasons) and counters EXACTLY
  equal, and the plans' trace digests equal, as the reference's
  ``tests/test_faults.py`` cases ask: quarantine with the healthy slot
  bitwise the clean run's (``decode_block`` 8 and 1, and a speculative
  round), strict raising after the cleanup, the sentinel off, quarantine
  releasing paged blocks, retries within and beyond the budget, injected
  exhaustion shed as ``pool_pressure``, deadline shedding, backpressure.
* A NaN row without any plan (NaN planted in one slot's KV rows) is
  quarantined under the default ``numeric_sentinel="count"`` while the
  other slot serves on bitwise; the poison mask is one more static buffer
  of the engine's graphs (``steps.GraphedStep`` / ``GraphedRound`` under
  the CPU stand-in ``ReplayGraph``): it recaptures nothing, and an
  all-False mask leaves every step's outputs bitwise unchanged.
"""
import numpy as np
import pytest
import torch

from repro.serving.faults import FaultPlan as RefFaultPlan
from repro.serving.faults import FaultSpec as RefFaultSpec
from repro.serving import faults as ref_faults
from repro_torch.core import errors as ERR
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.serving import Engine, FaultPlan, FaultSpec
from repro_torch.serving import faults as port_faults

from _torch_port import (no_activation_mesh, one_torch_thread,  # noqa: F401
                         model_pair, port_engine, ref_engine)
from test_torch_graph_steps import ReplayGraph

P, NEW = 8, 10
ENGINE = dict(arch="qwen3-moe-30b-a3b", n_slots=2, s_max=32,
              prefill_buckets=(P,))
#: counters only the reference's trace guard keeps (the port has no jit)
GUARD_COUNTERS = ("retraces", "implicit_transfers")


@pytest.fixture(scope="module")
def setup():
    rcfg, params, pcfg, model = model_pair("full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pcfg.vocab_size, size=P, dtype=np.int32)
               for _ in range(2)]
    return dict(rcfg=rcfg, params=params, pcfg=pcfg, model=model,
                prompts=prompts)


# ---------------------------------------------------------------------------
# the plan: the port's copy decides as the reference's
# ---------------------------------------------------------------------------

def test_splitmix64_and_hash_equal_the_reference():
    xs = [0, 1, 2, 7, 2 ** 32 - 1, 2 ** 63, 2 ** 64 - 1, 0x9E3779B97F4A7C15]
    assert [port_faults._splitmix64(x) for x in xs] == \
        [ref_faults._splitmix64(x) for x in xs]
    for seed in (0, 7, 2 ** 40 + 5):
        for site in port_faults.SITES:
            for step in (0, 3, 64):
                assert port_faults._hash(seed, site, step, 11) == \
                    ref_faults._hash(seed, site, step, 11)
    assert port_faults.SITES == ref_faults.SITES
    assert port_faults.KINDS == ref_faults.KINDS


BAD_SPECS = [dict(site="scheduler", kind="transient"),
             dict(site="alloc", kind="nan_logits"),
             dict(site="decode", kind="transient", p=1.5),
             dict(site="decode", kind="transient", fails=0)]


@pytest.mark.parametrize("kw", BAD_SPECS,
                         ids=["site", "kind", "p", "fails"])
def test_fault_spec_validation_as_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefFaultSpec(**kw)
    with pytest.raises(ValueError) as port_err:
        FaultSpec(**kw)
    assert str(port_err.value) == str(ref_err.value)


#: the grid's plans (spec keyword sets, in order)
PLANS = {
    "mixed": ({"site": "decode", "kind": "nan_logits", "p": 0.3},
              {"site": "decode", "kind": "transient", "p": 0.2, "fails": 2},
              {"site": "alloc", "kind": "exhaust", "p": 0.25},
              {"site": "ckpt", "kind": "corrupt", "steps": (0,)}),
    "pinned": ({"site": "decode", "kind": "nan_logits", "steps": (5, 17),
                "slots": (1, 3, 9)},
               {"site": "admit", "kind": "transient", "steps": (8,),
                "fails": 3}),
    "hash_slot": ({"site": "decode", "kind": "nan_logits", "steps": (2,)},
                  {"site": "decode", "kind": "nan_logits", "p": 0.1}),
    "summed": ({"site": "decode", "kind": "transient", "steps": (8,),
                "fails": 2},
               {"site": "decode", "kind": "transient", "p": 0.5},
               {"site": "admit", "kind": "transient", "p": 0.5}),
    "corrupt": ({"site": "ckpt", "kind": "corrupt", "steps": (0, 3),
                 "byte_offsets": (3, 100, -1)},
                {"site": "ckpt", "kind": "corrupt", "p": 0.5}),
}


def _decisions(plan):
    """A fixed consultation sequence standing in for an engine trace: every
    decision, then the trace, its counts and digest."""
    out = []
    for step in range(0, 64, 4):
        for k in (1, 4):
            out.append(plan.poison_mask(step, k, n_slots=4).tolist())
        out.append(plan.transient_failures("decode", step))
        out.append(plan.transient_failures("admit", step))
        out.append(plan.exhausted(step))
    for step in range(4):
        out.append(plan.corrupt(b"0123456789abcdef", step=step))
    return out, plan.trace, plan.counts(), plan.trace_digest()


@pytest.mark.parametrize("seed", [0, 3, 7, 8, 2 ** 40 + 5])
@pytest.mark.parametrize("plan", list(PLANS))
def test_plan_decisions_and_trace_digest_equal_the_reference(plan, seed):
    specs = PLANS[plan]
    ref = _decisions(RefFaultPlan(seed=seed, specs=tuple(
        RefFaultSpec(**kw) for kw in specs)))
    port = _decisions(FaultPlan(seed=seed, specs=tuple(
        FaultSpec(**kw) for kw in specs)))
    assert port == ref
    assert port[1], "the plan fired nothing: the grid tests nothing"


# ---------------------------------------------------------------------------
# the engine against a live reference engine on the same plan
# ---------------------------------------------------------------------------

def _plans(specs, seed=0):
    """(reference plan, port plan) of the same seed and spec keywords."""
    return (RefFaultPlan(seed=seed, specs=tuple(RefFaultSpec(**kw)
                                                for kw in specs)),
            FaultPlan(seed=seed, specs=tuple(FaultSpec(**kw)
                                             for kw in specs)))


def _outcome(eng, reqs, done, plan=None):
    """What the two engines must agree on: tokens, statuses (finish and shed
    reasons, deferral), the order run() returned them in, the counters and
    the plan's trace digest."""
    counters = {k: v for k, v in eng.counters.items()
                if k not in GUARD_COUNTERS}
    return dict(
        tokens={r.uid: [int(t) for t in r.out_tokens] for r in reqs},
        status={r.uid: (r.status, r.finish_reason, r.shed_reason,
                        r.deferred) for r in reqs},
        returned=[r.uid for r in done], counters=counters,
        digest=None if plan is None else plan.trace_digest(),
        counts=None if plan is None else plan.counts())


def _serve(eng, prompts, plan=None, submits=None, new=NEW):
    """Submit (``submits``: per-request submit keywords, default each
    prompt with ``new`` tokens) and run to the end."""
    submits = submits or [dict(max_new_tokens=new) for _ in prompts]
    reqs = [eng.submit(p, **kw) for p, kw in zip(prompts, submits)]
    return _outcome(eng, reqs, eng.run(), plan)


def _both(s, specs=(), seed=0, draft=False, **kw):
    """The same plan served by the reference engine and by the port's
    (``draft``: the model drafting for itself)."""
    rplan, pplan = _plans(specs, seed) if specs else (None, None)
    ref = ref_engine(s["rcfg"], s["params"], faults=rplan,
                     draft=(s["rcfg"], s["params"]) if draft else None,
                     **dict(ENGINE, **kw))
    port = port_engine(s["pcfg"], s["model"], faults=pplan,
                       draft=(s["pcfg"], s["model"]) if draft else None,
                       **dict(ENGINE, **kw))
    return (_serve(ref, s["prompts"], rplan), ref), \
        (_serve(port, s["prompts"], pplan), port)


@pytest.fixture(scope="module")
def clean(setup):
    """The fault-free run of both engines: uid -> tokens (equal)."""
    (ref, _), (port, eng) = _both(setup)
    assert port == ref
    assert all(st[0] == "ok" for st in port["status"].values())
    assert eng.counters["shed"] == eng.counters["quarantined"] == 0
    assert eng.counters["transient_retries"] == 0
    return port["tokens"]


def _nan(slots=(0,), steps=(2,)):
    return ({"site": "decode", "kind": "nan_logits", "steps": steps,
             "slots": slots},)


def test_clean_run_equals_the_reference(clean):
    assert sorted(clean) == [0, 1]
    assert all(len(t) == NEW for t in clean.values())


@pytest.mark.parametrize("decode_block", [8, 1],
                         ids=["fused-block", "step-loop"])
def test_nan_quarantine_equals_the_reference(setup, clean, decode_block):
    (ref, _), (port, eng) = _both(setup, _nan(), decode_block=decode_block)
    assert port == ref
    bad, good = port["tokens"][0], port["tokens"][1]
    assert port["status"][0][:2] == ("failed_numeric", "numeric")
    assert 1 <= len(bad) < NEW and bad == clean[0][:len(bad)]
    assert port["status"][1][0] == "ok" and good == clean[1]
    assert eng.counters["quarantined"] == 1
    assert port["counts"] == {"nan_logits": 1}


def test_nan_quarantine_in_a_spec_round_equals_the_reference(setup, clean):
    """The speculative round poisons the VERIFY logits; the model drafts for
    itself (every draft accepted), so the clean tokens are the plain
    engine's."""
    (ref, _), (port, eng) = _both(setup, _nan(slots=(1,), steps=(4,)),
                                  draft=True, spec_k=4)
    assert port == ref
    assert port["status"][1][0] == "failed_numeric"
    bad = port["tokens"][1]
    assert 1 <= len(bad) < NEW and bad == clean[1][:len(bad)]
    assert port["tokens"][0] == clean[0]
    assert eng.counters["tokens_drafted"] > 0


def test_strict_raises_after_cleanup_as_the_reference(setup, clean):
    rplan, pplan = _plans(_nan())
    engines = (ref_engine(setup["rcfg"], setup["params"], faults=rplan,
                          numeric_sentinel="strict", **ENGINE),
               port_engine(setup["pcfg"], setup["model"], faults=pplan,
                           numeric_sentinel="strict", **ENGINE))
    errors, outcomes = [], []
    for eng, plan, err in zip(engines, (rplan, pplan),
                              (Exception, ERR.NumericHealthError)):
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in setup["prompts"]]
        with pytest.raises(err, match="uid") as info:
            eng.run()
        errors.append(str(info.value))
        assert eng.counters["quarantined"] == 1
        outcomes.append(_outcome(eng, reqs, eng.run(), plan))  # survivors
    assert errors[0] == errors[1]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1]["tokens"][1] == clean[1]
    assert outcomes[1]["status"][1][0] == "ok"


def test_sentinel_off_serves_as_the_reference(setup):
    (ref, _), (port, eng) = _both(setup, _nan(), numeric_sentinel="off")
    assert port == ref
    assert eng.counters["quarantined"] == 0
    assert all(st[0] == "ok" for st in port["status"].values())
    assert len(port["tokens"][0]) == NEW


def test_quarantine_releases_paged_blocks_as_the_reference(setup, clean):
    (ref, reng), (port, eng) = _both(setup, _nan(), kv_layout="paged",
                                     kv_block=16)
    assert port == ref
    assert port["status"][0][0] == "failed_numeric"
    assert port["tokens"][1] == clean[1]
    assert eng._alloc.free_blocks == eng._alloc.nb == reng._alloc.nb
    eng._alloc.check_invariants()
    assert eng._alloc.state_dict() == reng._alloc.state_dict()


@pytest.mark.parametrize("site", ["decode", "admit"])
def test_retries_within_budget_as_the_reference(setup, clean, site):
    step = 8 if site == "decode" else 0
    (ref, _), (port, eng) = _both(
        setup, ({"site": site, "kind": "transient", "steps": (step,),
                 "fails": 2},), device_retries=2)
    assert port == ref
    assert eng.counters["transient_retries"] == 2
    assert port["tokens"] == clean


def test_retries_beyond_budget_raise_as_the_reference(setup):
    rplan, pplan = _plans(({"site": "decode", "kind": "transient",
                            "steps": (0,), "fails": 3},))
    errors = []
    for eng in (ref_engine(setup["rcfg"], setup["params"], faults=rplan,
                           device_retries=2, **ENGINE),
                port_engine(setup["pcfg"], setup["model"], faults=pplan,
                            device_retries=2, **ENGINE)):
        eng.submit(setup["prompts"][0], max_new_tokens=NEW)
        with pytest.raises(Exception, match="device_retries=2") as info:
            eng.run()
        errors.append((type(info.value).__name__, str(info.value),
                       eng.counters["transient_retries"]))
    assert errors[1] == errors[0] == (errors[0][0], errors[0][1], 2)
    assert errors[1][0] == ERR.DeviceStepError.__name__
    assert rplan.trace_digest() == pplan.trace_digest()


def test_exhaustion_sheds_pool_pressure_as_the_reference(setup):
    specs = ({"site": "alloc", "kind": "exhaust",
              "steps": tuple(range(0, 9))},)
    outcomes = []
    for mk, cfg, params, plan in zip(
            (ref_engine, port_engine),
            (setup["rcfg"], setup["pcfg"]), (setup["params"], setup["model"]),
            _plans(specs)):
        eng = mk(cfg, params, faults=plan, **dict(ENGINE, n_slots=1))
        outcomes.append(_serve(eng, setup["prompts"][:1], plan,
                               [dict(max_new_tokens=4, ttl=6.0)]))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1]["status"][0] == ("shed", "shed", "pool_pressure",
                                        True)
    assert outcomes[1]["tokens"][0] == [] and outcomes[1]["returned"] == [0]
    assert outcomes[1]["counters"]["shed"] == 1
    assert "exhaust" in outcomes[1]["counts"]


def test_deadline_shed_as_the_reference(setup):
    outcomes = []
    for mk, cfg, params in ((ref_engine, setup["rcfg"], setup["params"]),
                            (port_engine, setup["pcfg"], setup["model"])):
        eng = mk(cfg, params, **dict(ENGINE, n_slots=1))
        outcomes.append(_serve(eng, setup["prompts"], submits=[
            dict(max_new_tokens=16), dict(max_new_tokens=4, ttl=4.0)]))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1]["status"][0][0] == "ok"
    assert outcomes[1]["status"][1][:3] == ("shed", "shed", "deadline")


def test_backpressure_as_the_reference(setup):
    """reject_new raises at a full queue; shed_expired first sheds the
    expired request, admits the newcomer, and run() reports the shed one
    exactly once; a queue still full of live work rejects."""
    p0, p1 = setup["prompts"]
    seen = []
    for mk, cfg, params in ((ref_engine, setup["rcfg"], setup["params"]),
                            (port_engine, setup["pcfg"], setup["model"])):
        eng = mk(cfg, params, **dict(ENGINE, max_pending=1))
        eng.submit(p0, max_new_tokens=2, arrival_time=100.0)
        with pytest.raises(Exception, match="reject_new") as info:
            eng.submit(p1, max_new_tokens=2, arrival_time=100.0)
        first = (type(info.value).__name__, str(info.value))
        eng = mk(cfg, params, **dict(ENGINE, max_pending=1,
                                     backpressure="shed_expired"))
        stale = eng.submit(p0, max_new_tokens=2, deadline=-1.0)
        live = eng.submit(p1, max_new_tokens=2)
        assert stale.status == "shed" and stale.shed_reason == "deadline"
        out = _outcome(eng, [stale, live], eng.run())
        eng.submit(p0, max_new_tokens=2, arrival_time=100.0)
        with pytest.raises(Exception, match="could not") as info:
            eng.submit(p1, max_new_tokens=2, arrival_time=100.0)
        seen.append((first, out, str(info.value)))
    assert seen[1] == seen[0]
    assert seen[1][0][0] == ERR.QueueFullError.__name__
    assert sorted(seen[1][1]["returned"]) == [0, 1]


# ---------------------------------------------------------------------------
# a NaN row with no plan; the poison mask on the graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_nan_row_quarantines_the_slot(setup, clean, layout):
    """NaN planted in slot 0's KV rows after its first block makes its
    logits non-finite: under the default sentinel the slot is quarantined
    (its tokens up to the poisoned row kept), the other slot serves on,
    bitwise the clean run's, and a paged slot's blocks go back to the
    pool."""
    kw = dict(kv_layout="paged", kv_block=8) if layout == "paged" else {}
    eng = port_engine(setup["pcfg"], setup["model"], **dict(ENGINE, **kw))
    assert eng.ec.numeric_sentinel == "count"
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in setup["prompts"]]
    done = eng.step_block()
    assert done == [] and len(reqs[0].out_tokens) == 1 + eng.ec.decode_block
    slot = eng._slot_req.index(reqs[0])
    if layout == "paged":
        blocks = [b for b in eng._alloc.tab[slot] if b < eng._alloc.nb]
        eng.cache["kp"][:, blocks] = float("nan")
    else:
        eng.cache["k"][:, slot] = float("nan")
    done = eng.run()
    bad, good = reqs
    assert (bad.status, bad.finish_reason) == ("failed_numeric", "numeric")
    assert bad.out_tokens == clean[0][:1 + eng.ec.decode_block]
    assert good.status == "ok" and good.out_tokens == clean[1]
    assert eng.counters["quarantined"] == 1
    assert {r.uid for r in done} == {0, 1}
    if layout == "paged":
        eng._alloc.check_invariants()
        assert eng._alloc.free_blocks == eng._alloc.nb


@pytest.mark.parametrize("form", ["block", "step", "spec"])
def test_poison_mask_never_recaptures_a_graph(setup, clean, monkeypatch,
                                             form):
    """A plan poisoning slot 0 on the graph path (``Engine._graph_maker``
    patched to the stand-in :class:`ReplayGraph`): one capture per step
    kind, every block a replay, the tokens those of the eager engine on the
    same plan and the other slot's the clean run's (the step loop's and a
    self-drafting spec engine's clean tokens are the fused block's)."""
    kw = dict(ENGINE, decode_block=1 if form == "step" else 8)
    draft = (setup["pcfg"], setup["model"]) if form == "spec" else None
    specs = _nan(steps=(3,))
    outs = []
    for graphed in (True, False):
        monkeypatch.setattr(
            Engine, "_graph_maker",
            (lambda self: (lambda pool: ReplayGraph())) if graphed
            else (lambda self: None))
        plan = _plans(specs)[1]
        eng = port_engine(setup["pcfg"], setup["model"], faults=plan,
                          draft=draft, **kw)
        outs.append(_serve(eng, setup["prompts"], plan))
        if graphed:
            stats = eng.graph_stats()
            name = {"block": "decode block", "step": "decode step",
                    "spec": "spec round"}[form]
            decode_graphs = [k for k in stats if not k.startswith("admit")]
            assert decode_graphs == [name]
            admits = sum(v["replays"] for k, v in stats.items()
                         if k.startswith("admit ")
                         and not k.startswith("admit draft"))
            assert stats[name]["replays"] == \
                eng.counters["device_calls"] - 1, (stats, eng.counters)
            assert admits == 2
            assert not eng._in["poison"].any()     # the last block's mask
    assert outs[0] == outs[1]
    assert outs[0]["status"][0][0] == "failed_numeric"
    assert outs[0]["tokens"][1] == clean[1]


@pytest.mark.parametrize("form", ["decode", "multi", "spec"])
def test_all_false_poison_is_bitwise_the_step_without_it(setup, form):
    """The step builders with an all-False mask give bitwise the outputs and
    the cache of the same call without one; a True row is NaN in its logits
    only."""
    cfg, model = setup["pcfg"], setup["model"]
    B, K = 2, 4
    gen = torch.Generator().manual_seed(0)
    base = MD.init_slot_cache(cfg, B, 32, "cpu", block_size=8,
                              lookahead=K + 1)
    base["k"].normal_(generator=gen)
    base["v"].normal_(generator=gen)
    base["pos"].copy_(torch.tensor([5, 9], dtype=torch.int32))
    tok = torch.tensor([3, 17], dtype=torch.int32)
    act = torch.tensor([True, True])
    rem = torch.tensor([K, K], dtype=torch.int32)
    eos = torch.full((B,), -1, dtype=torch.int32)
    if form == "decode":
        step = ST.make_slot_decode(cfg)

        def call(cache, *poison):
            return step(model, cache, tok, act, None, *poison)
    elif form == "multi":
        step = ST.make_slot_decode_multi(cfg, K)

        def call(cache, *poison):
            return step(model, cache, tok, act, rem, eos, None, *poison)
    else:
        step = ST.make_slot_decode_spec(cfg, cfg, K)

        def call(cache, *poison):
            dcache = {n: t.clone() for n, t in cache.items()}
            out = step(model, model, cache, dcache, tok, act, rem, eos, None,
                       *poison)
            return out[:3]
    copies = [{n: t.clone() for n, t in base.items()} for _ in range(3)]
    plain = call(copies[0])
    zero = call(copies[1], torch.zeros(B, dtype=torch.bool))
    for a, b in zip(plain[:2], zero[:2]):
        assert torch.equal(a, b)
    for n in base:
        assert torch.equal(copies[0][n], copies[1][n]), n
    hit = call(copies[2], torch.tensor([False, True]))
    if form == "decode":
        assert torch.isnan(hit[0][1]).all() and torch.equal(hit[0][0],
                                                            plain[0][0])
        assert hit[1][:, 1].tolist() == [1, 0]
    else:
        assert hit[0][:K, 0, 2].all() and not hit[0][:K, 1, 2].any()
        assert torch.equal(hit[0][:K, 0], plain[0][:K, 0])
