"""The port's plain ``gather_swiglu_q`` / ``grouped_swiglu_q`` (what its CPU
path runs and what its int8 CUDA kernels are held against on the card) versus
the reference: the jnp dequant oracles in ``repro.kernels.ref`` and the Pallas
kernel bodies in interpret mode, on the same numpy inputs and the same int8
tables, over the case list of ``tests/test_kernels.py`` (duplicate top-k ids,
out-of-range ids, zero-sized groups, hetero live-masked pad rows); then
``moe_apply`` over a ``qexp`` layer against the reference's.

Tolerances. Both sides dequantize with one fp32 product per weight and keep
everything fp32 up to the one output rounding, so the only difference is the
order of the fp32 sums: fp32 outputs ``rtol=1e-4`` with ``atol`` 1e-5 of the
output scale; bf16 outputs one bf16 ulp of the output scale (a sum-order
difference may flip the final rounding). Inside the port, int8 gather ==
int8 grouped / ragged is BITWISE.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import quant as RQ
from repro.kernels import decode_moe as K_dm
from repro.kernels import grouped_mlp as K_gm
from repro.kernels import ref as ref_ref
from repro.models import moe as RM
from repro_torch import configs
from repro_torch.core import quant as Q
from repro_torch.kernels import _common, decode_moe, grouped_mlp, ops, ref
from repro_torch.models import model as MD
from repro_torch.models import moe as M

from _torch_port import no_activation_mesh, ref_tree_numpy  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6) if want.size else 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=scale / 128)


def _qinputs(T, d, f, E, k, dtype, seed, live=None):
    """numpy inputs, the reference's int8 tables of them, and the same
    tables as torch tensors."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    x = np.asarray(jnp.asarray(rng.standard_normal((T, d)) * 0.5, jd)
                   .astype(jnp.float32))
    ws = [rng.standard_normal(s) * 0.2 for s in ((E, d, f), (E, d, f),
                                                 (E, f, d))]
    if live is not None:
        for w in ws:
            w[live:] = 0
    qt = RQ.quantize_expert_tables(*[jnp.asarray(w, jd) for w in ws])
    pt = Q.QuantizedExpertTables(*[torch.from_numpy(np.array(a)) for a in qt])
    idx = rng.integers(0, live or E, (T, k)).astype(np.int32)
    w = rng.standard_normal((T, k)).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return (jnp.asarray(x, jd), torch.from_numpy(np.array(x)).to(td)), qt, pt, \
        idx, w


GATHER_CASES = {
    # name: (T, d, f, E, k, idx override, live)
    "decode-shape": (4, 24, 32, 8, 2, None, None),
    "single-token-single-expert": (1, 16, 16, 4, 1, None, None),
    "k3": (8, 32, 48, 8, 3, None, None),
    "k4": (6, 16, 16, 8, 4, None, None),
    "tiny-table": (3, 16, 32, 2, 2, None, None),
    "duplicate-ids": (4, 16, 16, 4, 2, [[1, 1], [2, 0], [3, 3], [0, 0]],
                      None),
    "out-of-range-ids": (5, 16, 16, 8, 2,
                         [[11, 0], [1, -7], [0, 0], [1, 1], [2, 2]], 5),
    "hetero-pad-rows": (5, 16, 16, 8, 2, None, 5),
    "T-zero": (0, 16, 16, 4, 2, None, None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_swiglu_q_vs_reference(case, dtype):
    T, d, f, E, k, idx, live = GATHER_CASES[case]
    (xj, xt), qt, pt, ridx, w = _qinputs(T, d, f, E, k, dtype, len(case),
                                         live)
    if idx is not None:
        ridx = np.asarray(idx, np.int32).reshape(T, k)
    got = ops.gather_swiglu_q(xt, pt, torch.from_numpy(ridx),
                              torch.from_numpy(w))
    assert got.shape == (T, d) and got.dtype == xt.dtype
    assert torch.isfinite(got.float()).all()
    ij, wj = jnp.asarray(ridx), jnp.asarray(w)
    _close(got, ref_ref.gather_swiglu_q(xj, qt, ij, wj), dtype)
    if T:
        _close(got, K_dm.gather_swiglu_q(xj, qt, ij, wj, interpret=True),
               dtype)
    rows = ref.gather_swiglu_q_rows(xt, pt, torch.from_numpy(ridx))
    assert rows.shape == (T, k, d) and rows.dtype == xt.dtype


GROUPED_CASES = {
    "empty-middle": [10, 0, 37, 17],
    "tiny-and-dominant": [1, 1, 1, 1, 60],
    "post-merge": [40, 0, 24, 0, 16, 0, 8, 0],
    "leading-empties": [0, 0, 16],
    "trailing-empties": [5, 0, 0, 0],
    "T-zero": [0, 0, 0, 0],
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_swiglu_q_vs_reference(case, dtype):
    sizes = GROUPED_CASES[case]
    d, f, E, T = 24, 32, len(sizes), sum(sizes)
    (xj, xt), qt, pt, _, _ = _qinputs(max(T, 1), d, f, E, 2, dtype, E)
    xj, xt = xj[:T], xt[:T]
    gs = np.asarray(sizes, np.int32)
    got = ops.grouped_swiglu_q(xt, pt, torch.from_numpy(gs))
    assert got.shape == (T, d) and got.dtype == xt.dtype
    _close(got, ref_ref.grouped_swiglu_q(xj, qt, jnp.asarray(gs)), dtype)
    if T:
        _close(got, K_gm.grouped_swiglu_q(xj, qt, jnp.asarray(gs), block_t=16,
                                          block_f=f, interpret=True), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [2, 8])
def test_gather_q_rows_equal_grouped_q_rows_bitwise(k, dtype):
    """The per-pair rows of the int8 gather form are BITWISE the int8
    grouped form's rows for the same (row, expert) pairs, and the combined
    result is the slot-order combine of them: the contract the CUDA kernels
    keep on the card."""
    T, d, f, E = 6, 24, 32, 8
    (_, x), _, pt, idx, w = _qinputs(T, d, f, E, k, dtype, 3)
    idx, w = torch.from_numpy(idx), torch.from_numpy(w)
    rows = ref.gather_swiglu_q_rows(x, pt, idx)
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    ys = ref.grouped_swiglu_q(x[order // k], pt,
                              torch.bincount(flat, minlength=E))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k)
    assert torch.equal(rows, ys[inv].reshape(T, k, d))
    assert torch.equal(ref.gather_swiglu_q(x, pt, idx, w),
                       ref.combine_in_order(rows, w).to(x.dtype))


def _qlayer(dtype, seed=0):
    """A reference MoE layer quantized by the reference, and the port's
    quantized layer holding the same tensors (dispatch "gather")."""
    cfgs = []
    for mod in (ref_configs, configs):
        cfg = mod.get("qwen3-moe-30b-a3b").reduced().replace(dtype=dtype)
        cfgs.append(cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                        dispatch="gather")))
    rcfg, pcfg = cfgs
    rq = RQ.quantize_moe_tree(RM.moe_init(rcfg, jax.random.PRNGKey(seed)))
    mod = Q.quantize_moe(MD.init(pcfg.replace(n_layers=1), "cpu").stack[0].moe)
    tree = ref_tree_numpy(rq)
    with torch.no_grad():
        for name, t in list(mod.named_parameters()) + list(
                mod.named_buffers()):
            src = tree
            for part in name.split("."):
                src = src[part]
            t.copy_(torch.from_numpy(np.array(src)).to(t.dtype))
    return rcfg, rq, pcfg, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
def test_moe_apply_qexp_vs_reference(dispatch, dtype):
    """``moe_apply`` over a quantized layer, decode-shaped (gather or
    ragged) and prefill-shaped (ragged), against the reference's on the same
    int8 tables."""
    rcfg, rq, pcfg, mod = _qlayer(dtype)
    rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe, dispatch=dispatch))
    pcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch=dispatch))
    jd, td = DTYPES[dtype]
    for shape in ((4, 1, 64), (2, 8, 64)):
        x = np.array(jnp.asarray(np.random.default_rng(5).standard_normal(
            shape) * 0.5, jd).astype(jnp.float32))
        want = RM.moe_apply(rcfg, rq, jnp.asarray(x, jd), need_aux=False).y
        got = M.moe_apply(pcfg, mod, torch.from_numpy(x).to(td),
                          need_aux=False).y
        assert got.dtype == td
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_gather_equals_int8_ragged_bitwise(dtype):
    _, _, pcfg, mod = _qlayer(dtype, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 1, 64)).astype(np.float32)).to(getattr(torch, dtype))
    g = M.moe_apply(pcfg, mod, x, need_aux=False).y
    rag = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch="ragged"))
    assert torch.equal(g, M.moe_apply(rag, mod, x, need_aux=False).y)


@pytest.mark.parametrize("name", ["gather_swiglu_q", "grouped_swiglu_q"])
def test_cpu_dispatch_takes_plain_int8_version_and_counts_no_launch(name):
    kern = ops.KERNELS[name]
    before = kern.LAUNCHES
    (_, x), _, pt, idx, w = _qinputs(2, 8, 8, 2, 1, "float32", 0)
    if name == "gather_swiglu_q":
        y = ops.gather_swiglu_q(x, pt, torch.from_numpy(idx),
                                torch.from_numpy(w))
    else:
        y = ops.grouped_swiglu_q(x, pt, torch.tensor([1, 1]))
    assert y.shape == x.shape and kern.LAUNCHES == before
    assert kern.plain is getattr(ref, name)


@pytest.mark.parametrize("wrapper", [decode_moe.gather_swiglu_q_rows,
                                     grouped_mlp.grouped_swiglu_q])
def test_int8_kernel_wrappers_refuse_cpu_tensors(wrapper):
    (_, x), _, pt, idx, _ = _qinputs(2, 8, 8, 2, 1, "float32", 0)
    arg = (torch.from_numpy(idx) if wrapper is decode_moe.gather_swiglu_q_rows
           else torch.tensor([1, 1]))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, pt, arg)


def test_int8_table_check_names_the_bad_tensor():
    (_, x), _, pt, _, _ = _qinputs(2, 8, 8, 2, 1, "float32", 0)
    _common.check_qtables("t", x, pt)
    bad = pt._replace(wd_scale=pt.wd_scale[:, :, :4])
    with pytest.raises(ValueError, match="wd_scale"):
        _common.check_qtables("t", x, bad)
    bad = pt._replace(wg=pt.wg.to(torch.float32))
    with pytest.raises(ValueError, match="wg"):
        _common.check_qtables("t", x, bad)
    bad = pt._replace(wu=pt.wu.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        _common.check_qtables("t", x, bad)
