"""The slice as a whole: the same staggered Poisson trace through the
reference ``Engine`` and the port's, token for token.

fp32 reduced configs (see ``_torch_port``: matmul reduction orders differ
across frameworks, and a bf16 near-tie would flip a token). A reference
engine costs several seconds of jit, so each reference scenario runs once
per module and the port's variants are compared with it; the reference's own
suite pins that its output does not depend on decode_block, dispatch or
admission batching.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import errors as ERR
from repro_torch.serving import Engine, EngineConfig, Request

from _torch_port import (no_activation_mesh,  # noqa: F401
                         ARCH, S_MAX, TRACE, engine_kwargs,
                         model_pair, port_engine, ref_engine, run_trace,
                         trace_requests)

EOS_REQ = 3          # the trace's request that stops on an eos token


def _tokens(done):
    return [list(r.out_tokens) for r in done]


@pytest.fixture(scope="module", params=["full", "merged"])
def scenario(request):
    """Models of one kind, the trace, the eos token (the third token the
    eos request generates without one) and the reference's served tokens for
    two corners of the configuration matrix."""
    rcfg, params, pcfg, model = model_pair(request.param)
    reqs = trace_requests(rcfg.vocab_size)
    free = run_trace(port_engine(pcfg, model, **engine_kwargs()), reqs)
    eos = {EOS_REQ: free[EOS_REQ].out_tokens[2]}
    ref = {}
    for key, kw in (("fused", engine_kwargs()),
                    ("stepwise", engine_kwargs(decode_block=1,
                                               dispatch="ragged",
                                               batch_admission=False))):
        done = run_trace(ref_engine(rcfg, params, **kw), reqs, eos)
        assert all(r.status == "ok" for r in done)
        ref[key] = _tokens(done)
    return dict(pcfg=pcfg, model=model, reqs=reqs, eos=eos, ref=ref,
                free=_tokens(free))


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "serial"])
@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
@pytest.mark.parametrize("K", [1, 8])
def test_engine_token_for_token_vs_reference(scenario, K, dispatch, batched):
    s = scenario
    eng = port_engine(s["pcfg"], s["model"], **engine_kwargs(
        decode_block=K, dispatch=dispatch, batch_admission=batched))
    done = run_trace(eng, s["reqs"], s["eos"])
    assert [r.uid for r in done] == list(range(len(TRACE)))
    assert all(r.status == "ok" for r in done)
    got = _tokens(done)
    assert got == s["ref"]["fused"]
    assert got == s["ref"]["stepwise"]
    # the trace really has its edge cases
    assert len(got[2]) == 1 and done[2].finish_reason == "length"
    assert done[EOS_REQ].finish_reason == "eos" and len(got[EOS_REQ]) == 3
    assert got[EOS_REQ] == s["free"][EOS_REQ][:3]
    full = [r for r in done if r.n_prompt + r.max_new_tokens == S_MAX + 1]
    assert full and all(len(r.out_tokens) == r.max_new_tokens for r in full)


def test_internal_contracts_and_counters(scenario):
    """Inside the port: fused-K == step-at-a-time, gather == ragged,
    batched == serial; one readback per admission group and per block."""
    s = scenario
    outs = {}
    for name, kw in (("base", {}), ("k1", dict(decode_block=1)),
                     ("k3", dict(decode_block=3)),
                     ("ragged", dict(dispatch="ragged")),
                     ("serial", dict(batch_admission=False))):
        eng = port_engine(s["pcfg"], s["model"], **engine_kwargs(**kw))
        admits, blocks = [], []
        admit, multi, single = eng._admit_step, eng._decode_multi, eng._decode
        eng._admit_step = lambda *a: (admits.append(1), admit(*a))[1]
        eng._decode_multi = lambda *a: (blocks.append(1), multi(*a))[1]
        eng._decode = lambda *a: (blocks.append(1), single(*a))[1]
        outs[name] = _tokens(run_trace(eng, s["reqs"], s["eos"]))
        c = eng.counters
        assert c["host_syncs"] == len(admits) + len(blocks)
        assert c["device_calls"] == len(admits) + len(blocks)
        assert c["tokens_out"] == sum(len(t) for t in outs[name])
        assert eng.idle and eng.n_active == 0
    assert all(o == outs["base"] for o in outs.values())


def test_full_slot_keeps_decoding_neighbours_intact(scenario):
    """A request that fills its slot exactly leaves ``pos == s_max`` behind
    and the slot rides along in later blocks: those steps write nothing out
    of range and the neighbours' tokens match their solo runs."""
    s = scenario
    pcfg, model = s["pcfg"], s["model"]
    rng = np.random.default_rng(2)
    filler = rng.integers(0, pcfg.vocab_size, 9, dtype=np.int32)
    other = rng.integers(0, pcfg.vocab_size, 4, dtype=np.int32)
    kw = dict(arch=ARCH, n_slots=2, s_max=12, prefill_buckets=(4, 12),
              decode_block=8)
    eng = port_engine(pcfg, model, **kw)
    a = eng.submit(filler, max_new_tokens=4)                 # 9 + 4 == 13
    b = eng.submit(other, max_new_tokens=9)
    eng.run()
    assert int(eng.cache["pos"][0]) == 12                    # == s_max
    solo = port_engine(pcfg, model, **kw)
    c = solo.submit(other, max_new_tokens=9)
    solo.run()
    assert b.out_tokens == c.out_tokens and len(a.out_tokens) == 4


def _small(**kw):
    base = dict(arch=ARCH, n_slots=2, s_max=16, prefill_buckets=(4, 8))
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def small_model():
    _, _, pcfg, model = model_pair("full")
    return pcfg, model


def test_submit_validation_boundaries(small_model):
    pcfg, model = small_model
    eng = Engine(_small(), cfg=pcfg, params=model, device="cpu")
    ok = np.arange(8, dtype=np.int32)
    with pytest.raises(ERR.RequestValidationError, match="empty"):
        eng.submit(np.zeros((0,), np.int32), 1)
    with pytest.raises(ERR.RequestValidationError, match="max_new_tokens"):
        eng.submit(ok, 0)
    with pytest.raises(ERR.InvalidTokenError):
        eng.submit(np.array([0, pcfg.vocab_size], np.int32), 1)
    with pytest.raises(ERR.InvalidTokenError):
        eng.submit(np.array([-1, 2], np.int32), 1)
    with pytest.raises(ERR.RequestValidationError, match="s_max"):
        eng.submit(np.zeros((17,), np.int32), 1)
    eng.submit(ok, 9)                                       # 8 + 9 == s_max + 1
    with pytest.raises(ERR.RequestValidationError, match="s_max"):
        eng.submit(ok, 10)
    eng.submit(ok, 1, uid=40)
    with pytest.raises(ERR.DuplicateUidError):
        eng.submit(ok, 1, uid=40)
    with pytest.raises(ERR.DuplicateUidError):
        eng.run([Request(uid=40, prompt=ok, max_new_tokens=1)])
    with pytest.raises(ValueError):                          # typed AND ValueError
        eng.submit(ok, 10)
    assert eng.bucket_for(3) == 4 and eng.bucket_for(9) == 16
    with pytest.raises(ValueError, match="no prefill bucket"):
        eng.bucket_for(17)
    done = eng.run()
    assert sorted(r.uid for r in done) == [0, 40]


def test_deadlines_shed_and_bounded_queue(small_model):
    pcfg, model = small_model
    eng = Engine(_small(n_slots=1, max_pending=2), cfg=pcfg, params=model,
                 device="cpu")
    p = np.arange(4, dtype=np.int32)
    first = eng.submit(p, 8)
    late = eng.submit(p, 2, ttl=1.0)            # expires while the slot is busy
    with pytest.raises(ERR.QueueFullError):
        eng.submit(p, 1)
    done = eng.run()
    assert first.status == "ok" and len(first.out_tokens) == 8
    assert late.status == "shed" and late.shed_reason == "deadline"
    assert late.out_tokens == [] and eng.counters["shed"] == 1
    assert {r.uid for r in done} == {first.uid, late.uid}


#: (EngineConfig values, what construction raises): what a later slice
#: adds still raises NotImplementedError; a ``spec_draft`` directory is
#: served (tests/test_torch_ckpt.py), so a missing one raises
#: FileNotFoundError, as the reference's ``load`` does
CONFIG_CASES = [
    (dict(kv_layout="paged", spec_draft="/x"), FileNotFoundError),
    (dict(kv_dtype="int8", kv_layout="paged", mesh="data=2,model=2"),
     NotImplementedError),
    (dict(spec_draft="/x"), FileNotFoundError),
    (dict(mesh="data=2,model=2"), NotImplementedError),
    (dict(snapshot_every_steps=4, snapshot_dir="/x"), NotImplementedError),
    (dict(trace_guard="count"), NotImplementedError),
    (dict(trace_guard="strict"), NotImplementedError),
]


@pytest.mark.parametrize(
    "kw,error", CONFIG_CASES,
    ids=[next(iter(kw)) + "=" + str(next(iter(kw.values())))
         for kw, _ in CONFIG_CASES])
def test_unsupported_engine_config_values_raise(small_model, kw, error):
    pcfg, model = small_model
    match = ("no committed checkpoint" if error is FileNotFoundError
             else "not served by this slice")
    with pytest.raises(error, match=match):
        Engine(_small(**kw), cfg=pcfg, params=model, device="cpu")


def test_unsupported_constructor_arguments_raise(small_model):
    pcfg, model = small_model
    with pytest.raises(NotImplementedError, match="fault plan"):
        Engine(_small(), cfg=pcfg, params=model, device="cpu", faults=object())
    # a draft model given in-process is served (tests/test_torch_spec.py);
    # its parameters without its config are refused, as by the reference
    with pytest.raises(ValueError, match="draft_cfg"):
        Engine(_small(), cfg=pcfg, params=model, device="cpu",
               draft_params=model)
    with pytest.raises(ValueError, match="kv_layout"):
        Engine(_small(kv_layout="ring"), cfg=pcfg, params=model, device="cpu")
    with pytest.raises(ValueError, match="decode_block"):
        Engine(_small(decode_block=0), cfg=pcfg, params=model, device="cpu")


def test_engine_config_keeps_the_reference_fields():
    from repro.serving import EngineConfig as RefEngineConfig
    ref = {f.name: f.default for f in dataclasses.fields(RefEngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert list(port) == list(ref)
    assert {k for k in ref if ref[k] != port[k]} == {"trace_guard"}


@pytest.mark.parametrize("mode", ["count", "strict", "off"])
def test_non_finite_logits_raise_unless_sentinel_off(small_model, mode):
    pcfg, model = small_model
    eng = Engine(_small(numeric_sentinel=mode, decode_block=4), cfg=pcfg,
                 params=model, device="cpu")
    eng.submit(np.arange(4, dtype=np.int32), 6)
    eng.step_block()                              # admission + a clean block
    saved = eng.params.final_ln.scale.clone()
    eng.params.final_ln.scale.fill_(float("nan"))
    try:
        if mode == "off":
            eng.step_block()
        else:
            with pytest.raises(ERR.NumericHealthError):
                eng.step_block()
    finally:
        eng.params.final_ln.scale.copy_(saved)


def test_default_seeded_init_is_reproducible():
    a = Engine(_small(seed=3), device="cpu")
    b = Engine(_small(seed=3), device="cpu")
    assert a.cfg.moe.dispatch == "gather" and a.cfg.moe.gather_max_tokens >= 2
    p = np.arange(5, dtype=np.int32)
    ra, rb = a.submit(p, 5), b.submit(p, 5)
    a.run(), b.run()
    assert ra.out_tokens == rb.out_tokens and len(ra.out_tokens) == 5
    assert torch.equal(a.params.stack[0].moe.wg, b.params.stack[0].moe.wg)
