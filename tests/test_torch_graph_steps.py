"""The step bodies the engine's CUDA graphs replay, on the CPU.

A CUDA graph runs only on the card, so these tests drive the graph machinery
of ``launch/steps.py`` (``StepGraph``, ``GraphedStep``, ``GraphedAdmit``) with
a stand-in for ``steps.CudaGraph``: :class:`ReplayGraph` captures by running
the body on a scratch copy of the cache (a CUDA capture runs nothing) and
replays by running it on the live cache and writing the results into the
captured output tensors, as a replay rewrites them. What they hold:

* the capturable bodies (the cache's ``slot_consts`` built once, ``pos``
  written in place, a device slot index) give bitwise the outputs and the
  cache of the eager builders and of the host-array admission, dense
  cache and paged pool (bf16 and int8), fp32 and bf16, at T 0 and 0.7;
* the hoisted constants (RoPE's ``inv_freq``, threefry's bounds) are
  bitwise the ones built at every step;
* every cache tensor and every input buffer keeps its storage across blocks
  and admissions;
* the body reads nothing on the host and builds no tensor from host data;
* one replay credits exactly the launches of an eager run, by kernel and
  route (a stand-in graph that replays nothing, wrappers that count);
* the engine on its graph path stays token for token the reference
  ``Engine`` on the staggered Poisson trace, dense and paged.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import quant as Q
from repro_torch.core import threefry as TF
from repro_torch.kernels import moe_tc
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.serving import Engine

from _torch_port import (no_activation_mesh,  # noqa: F401
                         ARCH, DENSE_ARCH, engine_kwargs, model_pair,
                         port_engine, ref_engine, run_trace, trace_requests)

B, S_MAX, KV_BLOCK, K = 3, 24, 8, 4
LAYOUTS = ("dense", "paged", "paged_int8")
TEMPERATURE = 0.7


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


class ReplayGraph:
    """Stand-in for ``steps.CudaGraph`` on the CPU (see the module
    docstring)."""

    reserved_bytes = 0

    def warm_up(self, body, cache, inputs):
        body(ST._clone_cache(cache), *inputs)

    def capture(self, body, cache, inputs):
        self._run = lambda: body(cache, *inputs)
        scratch = ST._clone_cache(cache)
        out = body(scratch, *inputs)
        if isinstance(out, tuple):      # the step hands back the live cache
            out = tuple(cache if o is scratch else o for o in out)
        self.out = out
        return out

    def instantiate(self):
        pass

    @torch.inference_mode()
    def replay(self):
        for old, new in zip(_tensors(self.out), _tensors(self._run())):
            old.copy_(new)


class NullGraph(ReplayGraph):
    """A stand-in whose replay runs nothing: only the launch credit moves."""

    def replay(self):
        pass


def serving_cfg(arch=ARCH, dtype="float32", dispatch="gather"):
    cfg = configs.get(arch).reduced().replace(dtype=dtype)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch,
            gather_max_tokens=max(cfg.moe.gather_max_tokens, B)))
    return cfg


def new_cache(cfg, layout):
    if layout == "dense":
        return MD.init_slot_cache(cfg, B, S_MAX, "cpu", block_size=KV_BLOCK)
    nb = B * S_MAX // KV_BLOCK
    cache = MD.init_paged_cache(
        cfg, B, S_MAX, "cpu", n_blocks=nb, block_size=KV_BLOCK,
        kv_dtype="int8" if layout == "paged_int8" else "bf16")
    cache["tab"][:B] = torch.arange(nb, dtype=torch.int32).reshape(B, -1)
    return cache


def prompts(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 16)).astype(
        np.int32))
    return toks, torch.tensor([16, 5, 11], dtype=torch.int32)


def admitted(cfg, model, layout):
    """A cache of B slots holding three prompts, admitted eagerly."""
    cache = new_cache(cfg, layout)
    toks, lengths = prompts(cfg)
    slots = np.arange(B, dtype=np.int32)
    if layout == "dense":
        _, first, _ = ST.make_slot_admit(cfg)(model, cache, toks, lengths,
                                              slots)
    else:
        _, first, _ = ST.make_slot_admit_paged(cfg)(
            model, cache, toks, lengths, slots,
            torch.zeros((B,), dtype=torch.int32))
    return cache, first


def block_inputs(first, seed=0):
    keys = TF.fold_in(TF.prng_key(seed + 1), torch.tensor([3, 7, 11]))
    return (first.clone(), torch.tensor([True, True, False]),
            torch.tensor([9, 2, 9], dtype=torch.int32),
            torch.full((B,), -1, dtype=torch.int32), keys)


def static_buffers(values):
    return tuple(torch.zeros_like(v) for v in values)


def assert_cache_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    """The reduced qwen3-moe in one dtype, random weights from a seed."""
    cfg = serving_cfg(dtype=request.param)
    return cfg, MD.init(cfg, "cpu", seed=0)


# ---------------------------------------------------------------------------
# the hoisted constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, DENSE_ARCH, "yi-34b",
                                  "qwen1.5-110b"])
def test_inv_freq_built_once_is_bitwise_the_per_step_one(arch):
    cfg = configs.get(arch)
    cache = MD.init_slot_cache(cfg.reduced(), 1, 16, "cpu")
    red = cfg.reduced()
    once = MD.slot_consts(red, cache).inv_freq
    assert torch.equal(once, L.rope_freqs(red.hd, red.rope_theta))
    assert torch.equal(once, MD._inv_freq(red, "cpu"))
    assert MD.slot_consts(red, cache)[1:] == (16, 16)
    paged = MD.init_paged_cache(red, 1, 16, "cpu", n_blocks=2, block_size=8)
    assert MD.slot_consts(red, paged)[1:] == (None, None)


@pytest.mark.parametrize("value", [0.0, 1.0, TF.TINY, 0.3])
def test_threefry_bound_built_once_is_bitwise_the_per_call_one(value):
    dev = torch.device("cpu")
    got = TF.bound(value, dev)
    assert got is TF.bound(value, dev)                # built once
    want = torch.tensor(value, dtype=torch.float32, device=dev)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_uniform_and_gumbel_unchanged_by_the_hoist():
    key = TF.fold_in(TF.prng_key(5), torch.tensor([0, 1, 2**31 + 3]))
    bits = TF.random_bits(key, 4096)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    want = {}
    for lo_v, hi_v in ((0.0, 1.0), (TF.TINY, 1.0), (-2.0, 3.0)):
        lo = torch.tensor(lo_v, dtype=torch.float32)
        hi = torch.tensor(hi_v, dtype=torch.float32)
        want[lo_v] = torch.maximum(lo, floats * (hi - lo) + lo)
        assert torch.equal(TF.uniform(key, 4096, lo_v, hi_v), want[lo_v])
    assert torch.equal(TF.gumbel(key, 4096),
                       -torch.log(-torch.log(want[TF.TINY])))


# ---------------------------------------------------------------------------
# the bodies against the eager builders, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_graphed_block_equals_the_eager_builder(models, layout, temperature):
    cfg, model = models
    cache, first = admitted(cfg, model, layout)
    eager_cache, graph_cache = ST._clone_cache(cache), ST._clone_cache(cache)
    eager = ST.make_slot_decode_multi(cfg, K, temperature)
    body = ST.make_slot_decode_multi(cfg, K, temperature,
                                     MD.slot_consts(cfg, graph_cache))
    vals = block_inputs(first)
    bufs = static_buffers(vals)
    graphed = ST.GraphedStep(body, model, graph_cache, bufs, ReplayGraph)
    for _ in range(2):
        want_block, want_act, _ = eager(model, eager_cache, *vals)
        got_block, got_act, got_cache = graphed(model, graph_cache, *vals)
        assert got_cache is graph_cache
        assert torch.equal(got_block, want_block)
        assert torch.equal(got_act, want_act)
        assert_cache_equal(graph_cache, eager_cache)
        vals = (want_block[-1, :, 0].clone(),) + vals[1:]
    assert graphed.graphs["step"].replays == 2


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE])
def test_graphed_single_step_equals_the_eager_builder(models, temperature):
    cfg, model = models
    cache, first = admitted(cfg, model, "dense")
    eager_cache, graph_cache = ST._clone_cache(cache), ST._clone_cache(cache)
    tok, act, _, _, keys = block_inputs(first)
    body = ST.make_slot_decode(cfg, temperature,
                               MD.slot_consts(cfg, graph_cache))
    graphed = ST.GraphedStep(body, model, graph_cache,
                             static_buffers((tok, act, keys)), ReplayGraph)
    eager = ST.make_slot_decode(cfg, temperature)
    for _ in range(3):
        want_logits, want_aux, _ = eager(model, eager_cache, tok, act, keys)
        got_logits, got_aux, _ = graphed(model, graph_cache, tok, act, keys)
        assert torch.equal(got_logits, want_logits)
        assert torch.equal(got_aux, want_aux)
        assert_cache_equal(graph_cache, eager_cache)
        tok = want_aux[:, 0].clone()


def host_array_admission(cfg, model, cache, layout, toks, lengths, slots,
                         pos0):
    """The admission through the host-array API: each row alone, the dense
    insert through ``insert_slots``, the paged one with host-array slots."""
    rows = []
    for i in range(len(slots)):
        if layout == "dense":
            logits, k, v = MD.prefill_slots(cfg, model, toks[i:i + 1],
                                            lengths[i:i + 1])
            MD.insert_slots(cache, slots[i:i + 1], k, v, lengths[i:i + 1])
        else:
            logits, _ = MD.admit_slots_paged(cfg, model, cache,
                                             toks[i:i + 1], lengths[i:i + 1],
                                             slots[i:i + 1], pos0[i:i + 1])
        rows.append(logits)
    logits = torch.cat(rows)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_graphed_admission_equals_the_host_array_admission(models, layout):
    cfg, model = models
    toks, lengths = prompts(cfg, seed=4)
    slots = np.array([2, 0, 1], np.int32)
    pos0 = torch.tensor([0, 8, 0], dtype=torch.int32)   # a prefix hit
    extra = () if layout == "dense" else (pos0,)
    host, graph_cache = new_cache(cfg, layout), new_cache(cfg, layout)
    want = host_array_admission(cfg, model, host, layout, toks, lengths,
                                slots, pos0)
    consts = MD.slot_consts(cfg, graph_cache)
    row = (ST.admit_row if layout == "dense" else ST.admit_row_paged)(cfg,
                                                                      consts)
    graphed = ST.GraphedAdmit(row, model, graph_cache, ReplayGraph)
    logits, greedy, out = graphed(model, graph_cache, toks, lengths, slots,
                                  *extra)
    assert out is graph_cache
    assert torch.equal(logits, want[0]) and torch.equal(greedy, want[1])
    assert_cache_equal(graph_cache, host)
    # the eager builder, which the card runs only in comparisons, too
    eager_cache = new_cache(cfg, layout)
    build = ST.make_slot_admit if layout == "dense" else \
        ST.make_slot_admit_paged
    e_logits, e_greedy, _ = build(cfg)(model, eager_cache, toks, lengths,
                                       slots, *extra)
    assert torch.equal(e_logits, want[0]) and torch.equal(e_greedy, want[1])
    assert_cache_equal(eager_cache, host)
    # a second group of another pad shape gets its own graph
    graphed(model, graph_cache, toks[:2, :8], torch.tensor([8, 3]),
            np.array([1, 2], np.int32), *(p[:2] for p in extra))
    assert sorted(graphed.graphs) == ["admit 16", "admit 8"]
    assert graphed.graphs["admit 16"].replays == 3


def test_insert_slot_equals_insert_slots():
    cfg = serving_cfg()
    gen = torch.Generator().manual_seed(0)
    k = torch.randn((cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd),
                    generator=gen)
    v = torch.randn(k.shape, generator=gen)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    a = MD.init_slot_cache(cfg, 4, 16, "cpu")
    b = MD.init_slot_cache(cfg, 4, 16, "cpu")
    MD.insert_slots(a, np.array([3, 1]), k, v, lengths)
    MD.insert_slot(b, torch.tensor([3, 1]), k, v, lengths)
    assert_cache_equal(a, b)


def test_graphed_step_refuses_another_cache(models):
    cfg, model = models
    cache, first = admitted(cfg, model, "dense")
    vals = block_inputs(first)
    body = ST.make_slot_decode_multi(cfg, K, 0.0, MD.slot_consts(cfg, cache))
    graphed = ST.GraphedStep(body, model, cache, static_buffers(vals),
                             ReplayGraph)
    with pytest.raises(ValueError, match="cache it was built for"):
        graphed(model, ST._clone_cache(cache), *vals)
    row = ST.admit_row(cfg, MD.slot_consts(cfg, cache))
    admit = ST.GraphedAdmit(row, model, cache, ReplayGraph)
    toks, lengths = prompts(cfg)
    with pytest.raises(ValueError, match="outside"):
        admit(model, cache, toks[:1], lengths[:1], np.array([B]))


# ---------------------------------------------------------------------------
# no host read in a body
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_host_reads():
    """Every way a step could read a tensor on the host or build one from
    host data raises inside the block."""
    def refuse(name):
        def fn(*a, **kw):
            raise AssertionError(f"{name} inside a capturable step body")
        return fn
    names = [(torch.Tensor, n) for n in ("item", "tolist", "cpu", "numpy",
                                         "__bool__", "__int__", "__float__",
                                         "__index__")] + [(torch, "tensor")]
    own = {(o, n): o.__dict__[n] for o, n in names if n in o.__dict__}
    try:
        for owner, name in names:
            setattr(owner, name, refuse(name))
        yield
    finally:
        for owner, name in names:
            if (owner, name) in own:
                setattr(owner, name, own[(owner, name)])
            else:
                delattr(owner, name)


def test_no_host_reads_refuses_a_host_read():
    with no_host_reads(), pytest.raises(AssertionError, match="item"):
        torch.zeros(1).item()
    assert torch.zeros(1).item() == 0.0


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_body_reads_nothing_on_the_host(models, layout, temperature):
    cfg, model = models
    cache, first = admitted(cfg, model, layout)
    body = ST.make_slot_decode_multi(cfg, K, temperature,
                                     MD.slot_consts(cfg, cache))
    vals = block_inputs(first)
    body(model, ST._clone_cache(cache), *vals)        # the warm-up
    with no_host_reads():
        block, _, _ = body(model, cache, *vals)
    assert block.shape == (K, B, 3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_admission_row_and_step_bodies_read_nothing_on_the_host(models,
                                                                layout):
    cfg, model = models
    cache, first = admitted(cfg, model, layout)
    consts = MD.slot_consts(cfg, cache)
    toks, lengths = prompts(cfg, seed=2)
    args = (toks[:1], lengths[:1], torch.tensor([1]))
    if layout == "dense":
        row = ST.admit_row(cfg, consts)
    else:
        row = ST.admit_row_paged(cfg, consts)
        args += (torch.tensor([0], dtype=torch.int32),)
    step = ST.make_slot_decode(cfg, TEMPERATURE, consts)
    tok, act, _, _, keys = block_inputs(first)
    row(model, ST._clone_cache(cache), *args)          # the warm-ups
    step(model, ST._clone_cache(cache), tok, act, keys)
    with no_host_reads():
        logits = row(model, cache, *args)
        step(model, cache, tok, act, keys)
    assert logits.shape == (1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# storage kept across blocks and admissions; the engine on its graph path
# ---------------------------------------------------------------------------

@pytest.fixture
def graphed_engines(monkeypatch):
    """Engines built after this take their graph path on the CPU, with
    :class:`ReplayGraph` for ``steps.CudaGraph``."""
    monkeypatch.setattr(Engine, "_graph_maker",
                        lambda self: (lambda pool: ReplayGraph()))


def _ptrs(eng):
    return ({n: t.data_ptr() for n, t in eng.cache.items()},
            {n: t.data_ptr() for n, t in eng._in.items()})


def _paged_kw(**kw):
    return dict(engine_kwargs(**kw), kv_layout="paged", kv_block=KV_BLOCK)


@pytest.mark.parametrize("kw", [
    engine_kwargs(), engine_kwargs(decode_block=1),
    _paged_kw(), dict(_paged_kw(), kv_dtype="int8")],
    ids=["dense", "dense-K1", "paged", "paged-int8"])
def test_storage_kept_across_blocks_and_admissions(graphed_engines, kw):
    _, _, pcfg, model = model_pair("full")
    eng = port_engine(pcfg, model, **kw)
    before = _ptrs(eng)
    reqs = trace_requests(pcfg.vocab_size)
    done = run_trace(eng, reqs)
    assert all(r.status == "ok" for r in done)
    assert _ptrs(eng) == before

    def graph_ptrs():
        return {(name, key): (id(g), [t.data_ptr() for t in g.inputs])
                for name, graphed in eng._graphed.items()
                for key, g in graphed.graphs.items()}
    graphs = graph_ptrs()
    name = "decode block" if kw["decode_block"] > 1 else "decode step"
    assert eng.graph_stats()[name]["replays"] > 0
    assert any(k.startswith("admit") for k in eng.graph_stats())
    # the same trace again: the same graphs, buffers and cache storage
    done = run_trace(eng, [dict(r, arrival_time=r["arrival_time"]
                                + eng.steps) for r in reqs])
    assert all(r.status == "ok" for r in done)
    assert graph_ptrs() == graphs and _ptrs(eng) == before


@pytest.fixture(scope="module")
def references():
    """The reference ``Engine``'s greedy tokens on the staggered trace,
    dense and paged (its own suite pins that they do not depend on
    decode_block)."""
    rcfg, params, pcfg, model = model_pair("full")
    reqs = trace_requests(rcfg.vocab_size)
    ref = {}
    for layout, kw in (("dense", engine_kwargs()), ("paged", _paged_kw())):
        done = run_trace(ref_engine(rcfg, params, **kw), reqs)
        assert all(r.status == "ok" for r in done)
        ref[layout] = [list(r.out_tokens) for r in done]
    return pcfg, model, reqs, ref


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_graph_engine_token_for_token_vs_reference(graphed_engines,
                                                   references, layout, K):
    pcfg, model, reqs, ref = references
    kw = engine_kwargs(decode_block=K) if layout == "dense" else _paged_kw(
        decode_block=K)
    eng = port_engine(pcfg, model, **kw)
    blocks = []
    multi, single = eng._decode_multi, eng._decode
    eng._decode_multi = lambda *a: (blocks.append(1), multi(*a))[1]
    eng._decode = lambda *a: (blocks.append(1), single(*a))[1]
    done = run_trace(eng, reqs)
    assert [list(r.out_tokens) for r in done] == ref[layout]
    c, stats = eng.counters, eng.graph_stats()
    # one readback per admission group and per block
    assert c["host_syncs"] == c["device_calls"]
    name = "decode block" if K > 1 else "decode step"
    assert stats[name]["replays"] == len(blocks)
    assert sum(s["replays"] for k, s in stats.items()
               if k.startswith("admit")) == len(reqs)   # one per prompt
    assert c["host_syncs"] - len(blocks) <= len(reqs)


@pytest.mark.parametrize("arch", [ARCH, DENSE_ARCH])
def test_graph_engine_sampled_equals_the_eager_engine(monkeypatch, arch):
    cfg = serving_cfg(arch)
    model = MD.init(cfg, "cpu", seed=0)
    reqs = trace_requests(cfg.vocab_size)
    kw = dict(engine_kwargs(arch=arch), temperature=TEMPERATURE)
    eager = [list(r.out_tokens) for r in run_trace(
        port_engine(cfg, model, **kw), reqs)]
    monkeypatch.setattr(Engine, "_graph_maker",
                        lambda self: (lambda pool: ReplayGraph()))
    graphed = [list(r.out_tokens) for r in run_trace(
        port_engine(cfg, model, **kw), reqs)]
    assert graphed == eager


# ---------------------------------------------------------------------------
# launches credited per replay
# ---------------------------------------------------------------------------

COUNTED = {"gather_swiglu": lambda x, *a: moe_tc.route(x.dtype, x.shape[1],
                                                       a[0].shape[2]),
           "grouped_swiglu": lambda x, *a: moe_tc.route(x.dtype, x.shape[1],
                                                        a[0].shape[2]),
           "gather_swiglu_q": lambda x, qt, *a: moe_tc.route_q(
               x.dtype, x.shape[1], qt.wg.shape[2]),
           "grouped_swiglu_q": lambda x, qt, *a: moe_tc.route_q(
               x.dtype, x.shape[1], qt.wg.shape[2]),
           "paged_attention": lambda *a: "cuda_core",
           "paged_attention_q": lambda *a: "cuda_core"}


@pytest.fixture
def counting(monkeypatch):
    """The ops wrappers the CPU path reaches count a launch of the route the
    card would take, as the kernel wrappers do there."""
    for name, route_of in COUNTED.items():
        plain = getattr(ops, name)

        def counted(*a, _plain=plain, _name=name, _route=route_of):
            ops.KERNELS[_name].count(_route(*a))
            return _plain(*a)
        monkeypatch.setattr(ops, name, counted)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("experts", ["bf16", "int8"])
@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_replay_credits_the_launches_of_an_eager_block(counting, layout,
                                                       dispatch, experts):
    cfg = serving_cfg(dtype="bfloat16", dispatch=dispatch)
    model = MD.init(cfg, "cpu", seed=0)
    if experts == "int8":
        Q.quantize_model_experts(model)
    cache, first = admitted(cfg, model, layout)
    vals = block_inputs(first)
    ops.reset_launch_counts()
    ST.make_slot_decode_multi(cfg, K)(model, ST._clone_cache(cache), *vals)
    eager = ops.route_launch_counts()
    assert sum(sum(r.values()) for r in eager.values()) > 0
    ops.reset_launch_counts()
    body = ST.make_slot_decode_multi(cfg, K, 0.0, MD.slot_consts(cfg, cache))
    graphed = ST.GraphedStep(body, model, cache, static_buffers(vals),
                             NullGraph)
    graphed(model, cache, *vals)
    assert ops.route_launch_counts() == eager       # warm-up, capture: none
    graphed(model, cache, *vals)
    graphed(model, cache, *vals)
    assert ops.route_launch_counts() == {
        n: {r: 3 * c for r, c in by_route.items()}
        for n, by_route in eager.items()}
    assert ops.launch_counts() == {n: 3 * sum(r.values())
                                   for n, r in eager.items()}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_replay_credits_the_launches_of_an_eager_admission(counting, layout):
    cfg = serving_cfg(dtype="bfloat16")
    model = MD.init(cfg, "cpu", seed=0)
    toks, lengths = prompts(cfg)
    slots = np.arange(B, dtype=np.int32)
    extra = () if layout == "dense" else (torch.zeros((B,), dtype=torch.int32),)
    build = ST.make_slot_admit if layout == "dense" else \
        ST.make_slot_admit_paged
    ops.reset_launch_counts()
    build(cfg)(model, new_cache(cfg, layout), toks, lengths, slots, *extra)
    eager = ops.route_launch_counts()
    assert sum(eager["grouped_swiglu"].values()) == B * cfg.n_layers
    ops.reset_launch_counts()
    cache = new_cache(cfg, layout)
    row = (ST.admit_row if layout == "dense" else ST.admit_row_paged)(
        cfg, MD.slot_consts(cfg, cache))
    ST.GraphedAdmit(row, model, cache, NullGraph)(model, cache, toks, lengths,
                                                  slots, *extra)
    assert ops.route_launch_counts() == eager
