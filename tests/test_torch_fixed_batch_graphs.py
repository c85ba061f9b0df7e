"""The fixed-batch server's CUDA graphs (``launch/serve.py ::
FixedBatchServer`` on its graph path: ``steps.GraphedPrefill`` and
``steps.GraphedStep`` over ``make_serve_prefill`` / ``make_serve_step``), on
the CPU, for mamba2-370m, zamba2-2.7b, whisper-base (with frames),
phi-3-vision-4.2b (with patches) and granite-8b, reduced, in their own type.

A CUDA graph runs only on the card, so the server's ``_graph_maker`` is
patched to hand out the stand-ins of ``test_torch_graph_steps.py``
(``ReplayGraph``: capture on a scratch copy of the cache, replay on the live
one into the captured outputs; ``NullGraph``: replays nothing). What they
hold:

* the graphed server is bitwise the eager one: the tokens, greedy and at
  temperature 0.7, and the prefill's and every step's logits, in a first
  call (which captures) and a second (which replays only);
* every cache tensor, the SSM states' too, and every static input buffer
  keeps its storage across calls; one step graph per (batch, ``s_max``),
  one prefill graph per prompt shape; another (batch, ``s_max``) frees the
  last one's cache and graphs;
* the prefill and step bodies read nothing on the host and build no tensor
  from host data;
* one replay credits exactly the launches of an eager step (and of an eager
  prefill), by kernel and route.
"""
import weakref

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from test_torch_graph_steps import NullGraph, ReplayGraph, no_host_reads

ARCHS = ("mamba2-370m", "zamba2-2.7b", "whisper-base", "phi-3-vision-4.2b",
         "granite-8b")
B, PROMPT, NEW = 2, 6, 5
TEMPERATURE = 0.7


def cfg_of(arch):
    return configs.get(arch).reduced()


def inputs(cfg, seed=0, prompt=PROMPT):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vlm_num_patches, cfg.d_model)).astype(np.float32)).to(
                cfg.param_dtype)
    if cfg.family == "audio":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)).to(
                cfg.param_dtype)
    return prompts, extra


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg = cfg_of(request.param)
    return cfg, MD.init(cfg, "cpu", seed=1)


def server(cfg, model, graph=None, temperature=0.0):
    """The port's server on the CPU; ``graph``: the stand-in class its
    graphs are made of (None: the eager bodies)."""
    srv = SV.FixedBatchServer(SV.ServeConfig(arch=cfg.name,
                                             max_new_tokens=NEW, seed=3,
                                             temperature=temperature),
                              cfg=cfg, model=model, device="cpu")
    if graph is not None:
        srv._new_graph = graph
    return srv


def cache_ptrs(cache):
    out = {}
    for name, t in cache.items():
        for i, x in enumerate(t if isinstance(t, tuple) else (t,)):
            out[(name, i)] = x.data_ptr()
    return out


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE],
                         ids=["greedy", "T0.7"])
def test_graphed_server_is_bitwise_the_eager_one(family, temperature):
    cfg, model = family
    prompts, extra = inputs(cfg)
    want_logits, got_logits = [], []
    want = server(cfg, model, temperature=temperature).generate(
        prompts, extra, logits_out=want_logits)
    graphed = server(cfg, model, ReplayGraph, temperature)
    for _ in range(2):                    # capture, then replay only
        got_logits.clear()
        got = graphed.generate(prompts, extra, logits_out=got_logits)
        np.testing.assert_array_equal(got, want)
        assert len(got_logits) == len(want_logits) == NEW + 1
        for i, (a, b) in enumerate(zip(got_logits, want_logits)):
            assert torch.equal(a, b), f"logits {i}"
    stats = graphed.graph_stats()
    s_max = PROMPT + NEW + (cfg.vlm_num_patches if cfg.family == "vlm"
                            else 0)
    prefill = f"{B}x{s_max} prefill {PROMPT}" + "".join(
        f" {k} {str(v.dtype).split('.')[-1]}" for k, v in sorted(
            extra.items()))
    assert sorted(stats) == [prefill, f"{B}x{s_max} step"]
    assert stats[f"{B}x{s_max} step"]["replays"] == 2 * NEW
    assert stats[prefill]["replays"] == 2


def test_cache_and_buffers_keep_their_storage(family):
    cfg, model = family
    srv = server(cfg, model, ReplayGraph)
    prompts, extra = inputs(cfg)
    first = srv.generate(prompts, extra)
    (key, graphed), = srv._graphed.items()
    cache = graphed["cache"]
    before = cache_ptrs(cache)
    buffers = [t.data_ptr() for part in ("prefill", "step")
               for g in graphed[part].graphs.values() for t in g.inputs]
    other, extra2 = inputs(cfg, seed=5)
    srv.generate(other, extra2)
    again = srv.generate(prompts, extra)
    np.testing.assert_array_equal(again, first)
    assert list(srv._graphed) == [key] and srv._graphed[key] is graphed
    assert cache_ptrs(cache) == before
    assert [t.data_ptr() for part in ("prefill", "step")
            for g in graphed[part].graphs.values() for t in g.inputs] \
        == buffers
    assert int(cache["pos"]) == key[1]            # the prompt and NEW steps


def test_another_shape_frees_the_last_shapes_cache_and_graphs(family):
    """The server holds the cache and graphs of one (batch, ``s_max``): a
    longer prompt drops the last entry, whose cache and graphs are freed at
    once (no reference cycle holds them), and captures its own; the first
    shape served again is captured anew, with the same tokens."""
    cfg, model = family
    srv = server(cfg, model, ReplayGraph)
    prompts, extra = inputs(cfg)
    first = srv.generate(prompts, extra)
    (key, graphed), = srv._graphed.items()
    cache = weakref.ref(graphed["cache"]["pos"])
    step = weakref.ref(graphed["step"])
    del graphed
    longer, extra2 = inputs(cfg, seed=6, prompt=PROMPT + 2)
    srv.generate(longer, extra2)
    assert list(srv._graphed) == [(B, key[1] + 2)]
    assert cache() is None and step() is None
    np.testing.assert_array_equal(srv.generate(prompts, extra), first)
    assert list(srv._graphed) == [key]


def test_prefill_and_step_bodies_read_nothing_on_the_host(family):
    cfg, model = family
    prompts, extra = inputs(cfg)
    batch = dict(tokens=torch.from_numpy(prompts), **extra)
    rows = PROMPT + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    cache = MD.init_cache(cfg, B, rows + NEW, "cpu")
    consts = MD.slot_consts(cfg, cache)
    prefill = ST.make_serve_prefill(cfg, consts=consts)
    step = ST.make_serve_step(cfg, consts)
    token = torch.zeros((B,), dtype=torch.int32)
    prefill(model, batch, ST._clone_cache(cache))            # the warm-ups
    step(model, ST._clone_cache(cache), token)
    want, fresh = MD.prefill(cfg, model, batch, s_max=rows + NEW)
    want_step = MD.decode_step(cfg, model, ST._clone_cache(fresh), token)[0]
    with no_host_reads():
        logits, out = prefill(model, batch, cache)
        filled = ST._clone_cache(cache)
        step_logits, _ = step(model, cache, token)
    assert out is cache and torch.equal(logits, want)
    assert_same_cache(filled, fresh)
    assert torch.equal(step_logits, want_step)


def assert_same_cache(a, b):
    assert a.keys() == b.keys()
    for name in a:
        pairs = zip(a[name], b[name]) if isinstance(a[name], tuple) \
            else [(a[name], b[name])]
        for x, y in pairs:
            assert torch.equal(x, y), name


def test_prefill_into_a_used_cache_is_a_new_cache(family):
    """A cache the server reuses holds the last call's rows past the
    prompt; the prefill zeroes them, so the cache ends as a new one."""
    cfg, model = family
    prompts, extra = inputs(cfg)
    batch = dict(tokens=torch.from_numpy(prompts), **extra)
    rows = PROMPT + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    _, fresh = MD.prefill(cfg, model, batch, s_max=rows + NEW)
    used = MD.init_cache(cfg, B, rows + NEW, "cpu")
    for name, t in used.items():
        for x in (t if isinstance(t, tuple) else (t,)):
            if name not in ("s_max", "kv_block"):       # the host scalars
                x.fill_(7)
    MD.prefill(cfg, model, batch, cache=used)
    assert_same_cache(used, fresh)


@pytest.fixture
def counting(monkeypatch):
    """The kernels the CPU path stands in for count a launch of the route
    the card takes, as their wrappers do there: flash at every
    full-sequence attention, swiglu_mlp at every MLP (none under train),
    paged at every decode attention."""
    def route(dtype):
        return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    attend, mlp, paged = L._attend, L.mlp_apply, ops.paged_attention

    def counted_attend(q, *a, train=False, **kw):
        if not train:
            ops.KERNELS["flash_attention"].count(route(q.dtype))
        return attend(q, *a, train=train, **kw)

    def counted_mlp(p, x, train=False):
        if not train:
            ops.KERNELS["swiglu_mlp"].count(route(x.dtype))
        return mlp(p, x, train=train)

    def counted_paged(*a):
        ops.KERNELS["paged_attention"].count()
        return paged(*a)
    monkeypatch.setattr(L, "_attend", counted_attend)
    monkeypatch.setattr(L, "mlp_apply", counted_mlp)
    monkeypatch.setattr(ops, "paged_attention", counted_paged)
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def test_a_replay_credits_an_eager_steps_launches(family, counting):
    cfg, model = family
    prompts, extra = inputs(cfg)
    batch = dict(tokens=torch.from_numpy(prompts), **extra)
    rows = PROMPT + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    token = torch.zeros((B,), dtype=torch.int32)
    ops.reset_launch_counts()
    _, cache = MD.prefill(cfg, model, batch, s_max=rows + NEW)
    eager_prefill = ops.route_launch_counts()
    ops.reset_launch_counts()
    MD.decode_step(cfg, model, cache, token)
    eager_step = ops.route_launch_counts()
    if cfg.family != "ssm":
        assert sum(eager_step["paged_attention"].values()) > 0
    ops.reset_launch_counts()
    srv = server(cfg, model, NullGraph)
    graphed = srv._graphed_for(B, rows + NEW)
    graphed["prefill"](model, batch)
    assert ops.route_launch_counts() == eager_prefill   # capture: none
    ops.reset_launch_counts()
    for _ in range(3):
        graphed["step"](model, graphed["cache"], token)
    assert ops.route_launch_counts() == {
        n: {r: 3 * c for r, c in by_route.items()}
        for n, by_route in eager_step.items()}
