"""The port's int8 quantizers (``repro_torch.core.quant``) against the
reference's (``repro.core.quant``): the int8 values and the fp32 scales are
compared BITWISE (same integer math: multiply by the reciprocal, round half to
even, clip to +-127, zero channel -> scale 0), for expert tables and for KV
rows, over fp32 and bf16 sources; then a reference ``qexp`` tree crosses the
converter and serves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro.models import model as RMD
from repro_torch import convert
from repro_torch.core import quant as Q
from repro_torch.models import moe as M

from _torch_port import (no_activation_mesh,  # noqa: F401
                         cfg_pair, engine_kwargs, port_engine, ref_engine,
                         ref_tree_numpy, run_trace, trace_requests)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _source(shape, dtype, seed, zero_axis=None, exact=False):
    """numpy values (fp32-exact in bf16 when rounded through it) with some
    all-zero channels and, with ``exact``, small integers times 0.25 that
    land on ties of the rounding."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * 0.3
    if exact:
        a = rng.integers(-600, 600, size=shape).astype(np.float32) * 0.25
    if zero_axis is not None:
        idx = [slice(None)] * len(shape)
        idx[zero_axis] = slice(0, 2)
        a[tuple(idx)] = 0.0
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("exact", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 24, 32), (2, 3, 16, 8), (5, 7)])
def test_quantize_channelwise_bitwise(shape, dtype, exact):
    # zero channels: output columns 0 and 1 (the last axis) of every table
    j, t = _source(shape, dtype, seed=len(shape), zero_axis=len(shape) - 1,
                   exact=exact)
    rq, rs = RQ.quantize_channelwise(j)
    q, s = Q.quantize_channelwise(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape[-2] == 1 and tuple(s.shape) == tuple(rs.shape)
    _eq(q, rq)
    _eq(s, rs)
    assert (s[..., :2] == 0).all() and (q[..., :2] == 0).all()
    # dequantize (one fp32 product, then the type) equals the reference's
    for out in (jnp.float32, jnp.bfloat16):
        tout = DTYPES["float32" if out == jnp.float32 else "bfloat16"][1]
        np.testing.assert_array_equal(
            Q.dequantize(q, s, tout).float().numpy(),
            np.asarray(RQ.dequantize(rq, rs, out).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 4, 2, 16), (6, 2, 128)])
def test_quantize_kv_bitwise(shape, dtype):
    # all-zero rows: heads 0 and 1 of every row
    j, t = _source(shape, dtype, seed=7, zero_axis=len(shape) - 2)
    rq, rs = RQ.quantize_kv(j)
    q, s = Q.quantize_kv(t)
    assert tuple(s.shape) == tuple(shape[:-1])
    _eq(q, rq)
    _eq(s, rs)
    for out in (jnp.float32, jnp.bfloat16):
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        np.testing.assert_array_equal(
            Q.dequantize_kv(q, s, tout).float().numpy(),
            np.asarray(RQ.dequantize_kv(rq, rs, out).astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["full", "merged", "hetero"])
def test_reference_qexp_tree_crosses_the_converter_intact(kind):
    """``repro.core.quant.quantize_model_experts`` quantizes every stack;
    the converted port model holds the same int8 / fp32 tensors, and the
    port's own quantizer applied to the unquantized conversion gives them
    too."""
    rcfg, pcfg = cfg_pair(kind, dtype="bfloat16")
    params = RMD.init(rcfg, jax.random.PRNGKey(3))
    qparams = RQ.quantize_model_experts(params)
    model = convert.from_reference_params(ref_tree_numpy(qparams), pcfg, "cpu")
    mine = Q.quantize_model_experts(
        convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu"))
    n = 0
    for key in ("stack", "stack_c"):
        if key not in qparams:
            assert not hasattr(model, key)
            continue
        ref_q = qparams[key]["moe"]["qexp"]
        for i, (blk, blk2) in enumerate(zip(getattr(model, key),
                                            getattr(mine, key))):
            assert Q.is_quantized(blk.moe) and not hasattr(blk.moe, "wg")
            for name in Q.QEXP_KEYS:
                got = getattr(blk.moe.qexp, name)
                assert got.dtype == (torch.float32 if name.endswith("_scale")
                                     else torch.int8)
                _eq(got, ref_q[name][i])
                assert torch.equal(got, getattr(blk2.moe.qexp, name))
            assert M.n_real_experts(blk.moe) == ref_q["wg"].shape[1]
            n += 1
    assert n == rcfg.n_layers


def test_converter_rejects_a_partial_qexp_set():
    rcfg, pcfg = cfg_pair("full")
    qparams = RQ.quantize_model_experts(RMD.init(rcfg, jax.random.PRNGKey(0)))
    tree = ref_tree_numpy(qparams)
    del tree["stack"]["moe"]["qexp"]["wd_scale"]
    with pytest.raises(ValueError, match="missing leaves.*wd_scale"):
        convert.from_reference_params(tree, pcfg, "cpu")
    tree = ref_tree_numpy(qparams)
    tree["stack"]["moe"]["wg"] = tree["stack"]["moe"]["qexp"]["wg"]
    with pytest.raises(ValueError, match="unexpected leaves"):
        convert.from_reference_params(tree, pcfg, "cpu")


def test_module_surgery_round_trip():
    """quantize_moe / dequantize_moe / is_quantized on a module: idempotent
    quantization, and the materialized tables equal ``dequantize``."""
    _, pcfg = cfg_pair("full")
    from repro_torch.models import model as MD
    model = MD.init(pcfg, "cpu", seed=1)
    moe = model.stack[0].moe
    wg = moe.wg.clone()
    Q.quantize_moe(moe)
    qg = moe.qexp.wg
    assert Q.quantize_moe(moe).qexp.wg is qg              # idempotent
    assert sum(p.numel() for p in moe.qexp.parameters()) > 0
    Q.dequantize_moe(moe, torch.float32)
    assert not Q.is_quantized(moe)
    q, s = Q.quantize_channelwise(wg)
    assert torch.equal(moe.wg, Q.dequantize(q, s, torch.float32))
    assert (moe.wg - wg).abs().max() <= s.max() / 2 + 1e-7


@pytest.mark.parametrize("kind", ["full", "merged"])
def test_int8_expert_engine_token_for_token_vs_reference(kind):
    """The int8-expert model served by the port's engine equals the
    reference Engine serving the same quantized tree, token for token
    (fp32 activations; the tables are int8 in both)."""
    rcfg, pcfg = cfg_pair(kind)
    params = RQ.quantize_model_experts(RMD.init(rcfg, jax.random.PRNGKey(0)))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    reqs = trace_requests(rcfg.vocab_size)
    want = [r.out_tokens for r in run_trace(
        ref_engine(rcfg, params, **engine_kwargs()), reqs)]
    for kw in (engine_kwargs(), engine_kwargs(decode_block=1,
                                              dispatch="ragged")):
        eng = port_engine(pcfg, model, **kw)
        assert eng.expert_weight_dtypes() == ("int8", "int8")
        got = [r.out_tokens for r in run_trace(eng, reqs)]
        assert got == want
