"""The dense MLP and the dense family against the reference (CPU).

* ``swiglu_mlp``'s plain version (``kernels/ref.py``) and its CPU dispatch
  (``kernels/ops.py``) against the reference's oracle and its Pallas kernel
  in interpret mode, over the reference's swiglu cases;
* the model's ``mlp_apply`` on a CPU tensor: the reference's model
  arithmetic, which rounds g and u to the model type, at fp32 and bf16;
* reduced ``granite-8b`` (fp32) with converted parameters: ``forward``
  logits, the slot prefill / insert / decode logits, and the staggered trace
  token for token through both engines, dense and paged, K = 1 and 8;
* reduced ``kimi-k2-1t-a32b`` (one shared expert, which runs ``mlp_apply``):
  ``moe_apply`` against the reference.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (it cannot run here).

Tolerances: the reference's own for the kernel cases (``tests/test_kernels
.py``: fp32 2e-5, bf16 2e-2, rtol and atol); fp32 model outputs to the order
of fp32 sums (``rtol 2e-4``, ``atol 2e-5 * max|y|``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import ref as RREF
from repro.kernels import swiglu as K_swiglu
from repro.models import layers as RL
from repro.models import model as RMD
from repro.models import moe as RM
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swiglu as SW
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import moe as M

from _torch_port import (no_activation_mesh,  # noqa: F401
                         DENSE_ARCH, S_MAX, TRACE, dense_pair, engine_kwargs,
                         port_engine, ref_engine, run_trace, trace_requests)

RNG = np.random.default_rng(42)


def _tol(dtype):
    """The reference's tolerance for its swiglu kernel cases."""
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def _inputs(T, d, f, dtype, scale=0.2, seed=None):
    """The same values in both frameworks: fp32 numpy rounded to ``dtype``
    through jnp (exact in torch afterwards)."""
    rng = RNG if seed is None else np.random.default_rng(seed)
    arrs = [rng.standard_normal((T, d)) * 0.5,
            rng.standard_normal((d, f)) * scale,
            rng.standard_normal((d, f)) * scale,
            rng.standard_normal((f, d)) * scale]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in j]
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


#: (T, d, f, block_t, block_f): the reference's swiglu shape cases, then
#: cases of its property test, T = 1, T not a multiple of any block, and a
#: wide f
CASES = [(32, 16, 32, 8, 8), (64, 32, 48, 16, 16), (128, 64, 64, 128, 64),
         (48, 24, 96, 16, 32), (40, 8, 48, 8, 16), (16, 24, 16, 16, 16),
         (1, 16, 32, 1, 16), (13, 24, 40, 13, 8), (5, 16, 1200, 5, 400)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,f,bt,bf", CASES,
                         ids=[f"T{c[0]}-d{c[1]}-f{c[2]}" for c in CASES])
def test_plain_version_equals_reference_oracle_and_kernel(T, d, f, bt, bf,
                                                          dtype):
    (jx, jwg, jwu, jwd), (x, wg, wu, wd) = _inputs(T, d, f, dtype)
    got = ref.swiglu_mlp(x, wg, wu, wd)
    assert got.dtype == x.dtype and got.shape == (T, d)
    # on a CPU tensor the dispatch takes the plain version, bit for bit
    assert torch.equal(ops.swiglu_mlp(x, wg, wu, wd), got)
    oracle = RREF.swiglu_mlp(jx, jwg, jwu, jwd)
    kernel = K_swiglu.swiglu_mlp(jx, jwg, jwu, jwd, block_t=bt, block_f=bf,
                                 interpret=True)
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))


def test_zero_weights_give_exactly_zero():
    (_, _, _, _), (x, wg, wu, wd) = _inputs(16, 8, 16, "float32")
    z, zd = torch.zeros_like(wg), torch.zeros_like(wd)
    assert float(ref.swiglu_mlp(x, z, z, zd).abs().max()) == 0.0
    assert float(ops.swiglu_mlp(x, z, z, zd).abs().max()) == 0.0


def test_the_plain_version_keeps_g_and_u_in_fp32():
    """The kernel's contract differs from the model's CPU arithmetic only in
    bf16, where the model rounds g and u: equal at fp32, apart at bf16."""
    d, f = 32, 64
    for dtype, apart in (("float32", False), ("bfloat16", True)):
        _, (x, wg, wu, wd) = _inputs(24, d, f, dtype, scale=0.5, seed=1)
        mod = L.MLP(d, f, getattr(torch, dtype), "cpu", torch.Generator())
        for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
            getattr(mod, name).copy_(w)
        kern, model = _np(ref.swiglu_mlp(x, wg, wu, wd)), _np(L.mlp_apply(
            mod, x))
        assert (not np.array_equal(kern, model)) == apart
        # fp32: the order of fp32 sums; bf16: g and u rounded to bf16 (2^-8
        # relative each) move the output by a few bf16 ulps of its scale
        scale = float(np.abs(kern).max())
        np.testing.assert_allclose(
            kern, model, rtol=0,
            atol=scale * (2.0 ** -5 if apart else 2e-5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_on_cpu_is_the_reference_model_arithmetic(dtype):
    """bf16: both round g, u and h to bf16 (``ein``), but the reference's
    bf16 silu rounds in other places than PyTorch's: two bf16 ulps at the
    output's scale (2^-6 * max|y|). fp32: the order of fp32 sums."""
    d, f = 64, 128
    (jx, jwg, jwu, jwd), (x, wg, wu, wd) = _inputs(18, d, f, dtype, seed=2)
    mod = L.MLP(d, f, getattr(torch, dtype), "cpu", torch.Generator())
    for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
        getattr(mod, name).copy_(w)
    x3 = x.reshape(2, 9, d)
    got = L.mlp_apply(mod, x3)
    assert got.shape == (2, 9, d) and got.dtype == x.dtype
    want = _np(RL.mlp_apply(dict(wg=jwg, wu=jwu, wd=jwd), jx.reshape(2, 9, d)))
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=2e-4,
                                   atol=2e-5 * scale)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=scale / 64)


def test_wrapper_checks_its_arguments():
    _, (x, wg, wu, wd) = _inputs(4, 16, 32, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        SW.swiglu_mlp(x, wg, wu, wd)
    assert SW._check(x, wg, wu, wd) == (4, 16, 32)
    with pytest.raises(ValueError, match="wd"):
        SW._check(x, wg, wu, wd.t().contiguous()[:, :16])
    with pytest.raises(TypeError, match="wu"):
        SW._check(x, wg, wu.double(), wd)
    with pytest.raises(ValueError, match="contiguous"):
        SW._check(x, wg, wu, wd.t().contiguous().t())
    with pytest.raises(ValueError, match="x"):
        SW._check(x[:, None], wg, wu, wd)
    # the model path never reaches the kernel on the CPU
    assert SW.SWIGLU.LAUNCHES == 0 and SW.SWIGLU.plain is ref.swiglu_mlp
    assert ops.KERNELS["swiglu_mlp"] is SW.SWIGLU


# ---------------------------------------------------------------------------
# the dense family: reduced granite-8b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    rcfg, params, pcfg, model = dense_pair()
    assert pcfg.family == "dense" and pcfg.moe is None
    assert all(hasattr(b, "mlp") for b in model.stack)
    return rcfg, params, pcfg, model


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


def test_granite_forward_logits_vs_reference(granite):
    rcfg, params, pcfg, model = granite
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 24))
    toks = toks.astype(np.int32)
    want, _, _ = RMD.forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    got, _, _ = MD.forward(pcfg, model, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(MD.loss(pcfg, model, {"tokens": torch.from_numpy(toks)})[0]) \
        == pytest.approx(float(RMD.loss(rcfg, params,
                                        {"tokens": jnp.asarray(toks)})[0]),
                         rel=1e-5)


def test_granite_slot_prefill_and_decode_vs_reference(granite):
    rcfg, params, pcfg, model = granite
    rng = np.random.default_rng(1)
    n_slots, s_max = 3, 16
    toks = rng.integers(0, rcfg.vocab_size, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 3], np.int32)
    slots = np.array([2, 0, 1], np.int32)
    rcache = RMD.init_slot_cache(rcfg, n_slots, s_max)
    rl, rk, rv = RMD.prefill_slots(rcfg, params, jnp.asarray(toks),
                                   jnp.asarray(lengths))
    rcache = RMD.insert_slots(rcache, jnp.asarray(slots), rk, rv,
                              jnp.asarray(lengths))
    cache = MD.init_slot_cache(pcfg, n_slots, s_max, "cpu")
    pl_, pk, pv = MD.prefill_slots(pcfg, model, torch.from_numpy(toks),
                                   torch.from_numpy(lengths))
    MD.insert_slots(cache, slots, pk, pv, torch.from_numpy(lengths))
    _close(pl_, rl)
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)[[1, 2, 0]]
    active = np.array([True, True, True])
    for _ in range(4):
        rlog, rcache = RMD.decode_step_slots(rcfg, params, rcache,
                                             jnp.asarray(tok),
                                             jnp.asarray(active))
        plog, cache = MD.decode_step_slots(pcfg, model, cache,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(active))
        _close(plog, rlog)
        tok = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)
        np.testing.assert_array_equal(plog.argmax(-1).numpy(), tok)


def _tokens(done):
    return [list(r.out_tokens) for r in done]


def _engine_kw(layout, K=8):
    kw = engine_kwargs(decode_block=K, arch=DENSE_ARCH)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block=4)
    return kw


@pytest.fixture(scope="module")
def granite_trace(granite):
    rcfg, params, pcfg, model = granite
    reqs = trace_requests(rcfg.vocab_size)
    ref = {}
    for layout in ("dense", "paged"):
        done = run_trace(ref_engine(rcfg, params, **_engine_kw(layout)), reqs)
        assert all(r.status == "ok" for r in done)
        ref[layout] = _tokens(done)
    assert ref["paged"] == ref["dense"]
    return pcfg, model, reqs, ref


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_granite_engine_token_for_token_vs_reference(granite_trace, layout, K):
    pcfg, model, reqs, ref = granite_trace
    eng = port_engine(pcfg, model, **_engine_kw(layout, K))
    done = run_trace(eng, reqs)
    assert [r.uid for r in done] == list(range(len(TRACE)))
    assert all(r.status == "ok" for r in done)
    assert _tokens(done) == ref[layout]
    full = [r for r in done if r.n_prompt + r.max_new_tokens == S_MAX + 1]
    assert full and all(len(r.out_tokens) == r.max_new_tokens for r in full)
    assert eng.counters["host_syncs"] == eng.counters["device_calls"]
    assert eng.expert_weight_dtypes() == ("bf16", "bf16")


# ---------------------------------------------------------------------------
# the MoE shared expert: reduced kimi-k2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 6], ids=["decode-shaped", "prefill-shaped"])
@pytest.mark.parametrize("dispatch", ["gather", "ragged", "dense"])
def test_kimi_shared_expert_moe_apply_vs_reference(dispatch, S):
    rcfg, params, pcfg, model = dense_pair("kimi-k2-1t-a32b")
    assert pcfg.moe.n_shared_experts == 1 and hasattr(model.stack[0].moe,
                                                      "shared")
    rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, dispatch=dispatch))
    pcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch=dispatch))
    p0 = jax.tree.map(lambda a: a[0], params["stack"]["moe"])
    x = np.random.default_rng(3).standard_normal(
        (4, S, rcfg.d_model)).astype(np.float32)
    want = RM.moe_apply(rcfg, p0, jnp.asarray(x), need_aux=False).y
    got = M.moe_apply(pcfg, model.stack[0].moe, torch.from_numpy(x),
                      need_aux=False).y
    _close(got, want)
    # the shared expert's share of the output is there
    share = L.mlp_apply(model.stack[0].moe.shared, torch.from_numpy(x))
    assert float(share.abs().max()) > 1e-3


def test_dense_family_configs_match_the_reference_widths():
    for arch in (DENSE_ARCH, "yi-34b", "qwen1.5-110b"):
        a, b = ref_configs.get(arch), configs.get(arch)
        assert (a.d_model, a.d_ff, a.n_layers, a.vocab_size) == \
            (b.d_model, b.d_ff, b.n_layers, b.vocab_size)
        assert b.family == "dense" and b.moe is None


# ---------------------------------------------------------------------------
# the kernel's routes: the tensor-core tile plan, the dtype route, refusals
# ---------------------------------------------------------------------------

#: (d, f) of every MLP the port serves: granite-8b, yi-34b, qwen1.5-110b,
#: kimi-k2's shared expert and the reduced configs
SERVED_WIDTHS = [(4096, 14336), (7168, 20480), (8192, 49152), (7168, 2048),
                 (64, 128)]


def _csrc(name):
    from repro_torch.kernels import _build
    return (_build.CSRC / name).read_text()


def _constexpr(src, name):
    import re
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tile_plan_constants_are_the_kernels():
    src = _csrc("swiglu_mlp.cu")
    assert (SW.N_TILE, SW.K_TILE, SW.MAX_SLICES) == (
        _constexpr(src, "kBN"), _constexpr(src, "kBK"),
        _constexpr(src, "kMaxSlices"))


def test_tile_plan_never_reads_the_token_count():
    import inspect
    assert list(inspect.signature(SW.plan).parameters) == ["d", "f", "n_sms"]
    assert {f.name for f in dataclasses.fields(SW.Plan)} == {
        "n_tile", "k_tile", "bounds"}
    assert SW.plan(4096, 14336, 132) == SW.plan(4096, 14336, 132)


@pytest.mark.parametrize("n_sms", [1, 16, 114, 132])
@pytest.mark.parametrize("d,f", SERVED_WIDTHS)
def test_tile_plan_partitions_f_and_covers_the_columns(d, f, n_sms):
    p = SW.plan(d, f, n_sms)
    b = p.bounds
    assert b[0] == 0 and b[-1] == f and 1 <= p.slices <= SW.MAX_SLICES
    assert all(lo < hi for lo, hi in zip(b, b[1:]))       # no empty slice
    assert all(x % p.k_tile == 0 for x in b[:-1])          # whole k-tiles
    k_tiles = [-(-(hi - lo) // p.k_tile) for lo, hi in zip(b, b[1:])]
    assert max(k_tiles) - min(k_tiles) <= 1                # dealt evenly
    cols = -(-d // p.n_tile)
    # as many slices as fit on the card at once, or one per k-tile
    assert (cols * p.slices <= SW.DOWN_BLOCKS_PER_SM * n_sms
            or p.slices == 1)
    assert (p.slices == SW.MAX_SLICES or p.slices == -(-f // p.k_tile)
            or cols * (p.slices + 1) > SW.DOWN_BLOCKS_PER_SM * n_sms)
    for width in (d, f):
        tiles = p.column_tiles(width)
        assert tiles[0][0] == 0 and tiles[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        assert all(0 < hi - lo <= p.n_tile for lo, hi in tiles)


def test_granite_plan_fills_the_card():
    """granite-8b on 132 SMs: 32 column tiles of the down pass x 8 slices =
    264 blocks, two on every SM."""
    p = SW.plan(4096, 14336, 132)
    assert p.slices == 8 and len(p.column_tiles(4096)) == 32
    assert len(p.column_tiles(14336)) == 112


def test_dtype_route_chooses_the_entry_point_without_launching():
    assert SW.route(torch.bfloat16) == "tensor_core"
    assert SW.route(torch.float32) == "cuda_core"
    assert SW.ENTRY == {"tensor_core": "swiglu_mlp_tc_launch",
                        "cuda_core": "swiglu_mlp_launch"}
    with pytest.raises(TypeError, match="float16"):
        SW.route(torch.float16)
    src = _csrc("swiglu_mlp.cu")
    for symbol in SW.ENTRY.values():
        assert f'extern "C" int {symbol}(' in src
    # both routes count their launches apart; nothing launched here
    assert SW.SWIGLU.ROUTE_LAUNCHES == {"tensor_core": 0, "cuda_core": 0}
    assert ops.route_launch_counts()["swiglu_mlp"] == SW.SWIGLU.ROUTE_LAUNCHES


@pytest.mark.parametrize("d,f", [(20, 32), (24, 36), (23, 31)])
def test_bf16_widths_not_multiples_of_8_are_refused(d, f):
    _, (x, wg, wu, wd) = _inputs(3, d, f, "bfloat16")
    with pytest.raises(ValueError, match="multiples of 8"):
        SW._check(x, wg, wu, wd)
    _, (x, wg, wu, wd) = _inputs(3, d, f, "float32")
    assert SW._check(x, wg, wu, wd) == (3, d, f)       # the CUDA-core route
    assert SW.SWIGLU.LAUNCHES == 0


def test_route_counts_reset_with_the_launch_counts():
    kern = SW.SWIGLU
    kern.count("tensor_core")
    kern.count("cuda_core")
    kern.count("tensor_core")
    try:
        assert kern.LAUNCHES == 3
        assert ops.route_launch_counts()["swiglu_mlp"] == {
            "tensor_core": 2, "cuda_core": 1}
    finally:
        ops.reset_launch_counts()
    assert kern.LAUNCHES == 0 and set(kern.ROUTE_LAUNCHES.values()) == {0}
