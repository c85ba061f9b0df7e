"""The tensor-core route of the int8 MoE pair ``gather_swiglu_q`` /
``grouped_swiglu_q`` on the CPU (the kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against their plain versions).

* The tile's arithmetic (``csrc/moe_tc_sm90.cuh``'s int8 contract), emulated
  here in plain PyTorch and nowhere on the main path: bf16 x times the int8
  tables widened to bf16 (exact) summed in fp32, each output column's scale
  applied after the sum, h = silu(g) * u in fp32 kept as a bf16 hi + lo pair,
  y = s_d * (hi . q_d + lo . q_d) rounded once. It is held against the
  reference's Pallas kernels in interpret mode (``tests/test_kernels.py``'s
  way) and its jnp oracles, and against the port's plain version, over the
  case list of ``tests/test_torch_kernels_q.py``. Tolerance: two bf16 ulps
  of max|y| (``chip_smoke.py :: moe_tol_q``): the output is rounded once
  (half an ulp), the fp32 sums run in another order and the scale after the
  sum (a few fp32 ulps), h keeps 2^-16 of itself (256 times below an ulp of
  y), and the reference's own bf16 rounding of its output adds half an ulp.
* The hi / lo split: |h - hi - lo| <= 2^-16 |h| over random fp32, and
  hi == h, lo == 0 where h is a bf16 number.
* ``moe_tc.route_q`` / ``plan_q``: bf16 with d and f multiples of 16 ->
  tensor cores, anything else -> CUDA cores; ``plan``'s tiles with the
  header's ``kStagesQ``.
* Both int8 wrappers, driven against a stubbed launcher, launch the entry of
  the route of (dtype, d, f) once and count by it, and the combined gather
  hands the combine pass w and its result on both routes; the CPU path counts
  no launch.
* The combine pass's arithmetic (``moe_swiglu.cuh :: combine_kernel``: product
  and sum each rounded to fp32, j ascending, from 0) is
  ``ref.combine_in_order``, bitwise.
"""
import inspect
import re
from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import decode_moe as K_dm
from repro.kernels import grouped_mlp as K_gm
from repro.kernels import ref as ref_ref
from repro_torch.core import quant as Q
from repro_torch.kernels import _build, _common, decode_moe, grouped_mlp, moe_tc
from repro_torch.kernels import ops, ref

from _torch_port import no_activation_mesh  # noqa: F401
from test_torch_kernels_q import GATHER_CASES, GROUPED_CASES, _qinputs

F32 = torch.float32


# ---------------------------------------------------------------------------
# the tile's arithmetic
# ---------------------------------------------------------------------------

def split_hi_lo(h: torch.Tensor):
    """h (fp32) as bf16 hi = round(h) and lo = round(h - hi)."""
    hi = h.to(torch.bfloat16)
    return hi, (h - hi.to(F32)).to(torch.bfloat16)


def tile_rows(x: torch.Tensor, qt, eid: torch.Tensor) -> torch.Tensor:
    """Row r of bf16 ``x`` through expert ``eid[r]`` as the tensor-core tile
    computes it; [n, d] bf16."""
    if x.shape[0] == 0:
        return x.clone()
    xf = x.to(F32)[:, None]                                   # [n, 1, d]
    g = torch.bmm(xf, qt.wg[eid].to(F32))[:, 0] * qt.wg_scale[eid][:, 0]
    u = torch.bmm(xf, qt.wu[eid].to(F32))[:, 0] * qt.wu_scale[eid][:, 0]
    hi, lo = split_hi_lo(F.silu(g) * u)
    qd = qt.wd[eid].to(F32)                                    # [n, f, d]
    hl = torch.cat([hi, lo], -1).to(F32)[:, None]             # [n, 1, 2f]
    acc = torch.bmm(hl, torch.cat([qd, qd], 1))[:, 0]
    return (acc * qt.wd_scale[eid][:, 0]).to(torch.bfloat16)


def tile_gather(x, qt, idx, w):
    """The int8 gather on tensor cores: per-pair rows, then the combine."""
    T, k = idx.shape
    E = qt.wg.shape[0]
    eid = idx.reshape(-1).long().clamp(0, E - 1)
    rows = tile_rows(x.repeat_interleave(k, dim=0), qt, eid)
    return ref.combine_in_order(rows.reshape(T, k, x.shape[1]), w).to(x.dtype)


def tile_grouped(x, qt, group_sizes):
    return tile_rows(x, qt, ref.rows_to_experts(group_sizes, x.shape[0]))


def _two_ulps(got, want):
    got = np.asarray(got.to(F32) if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.to(F32) if isinstance(want, torch.Tensor)
                      else jnp.asarray(want).astype(jnp.float32), np.float32)
    scale = max(float(np.abs(want).max()), 1e-6) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * scale / 128)


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_tile_arithmetic_gather_vs_reference(case):
    T, d, f, E, k, idx, live = GATHER_CASES[case]
    (xj, xt), qt, pt, ridx, w = _qinputs(T, d, f, E, k, "bfloat16", len(case),
                                         live)
    if idx is not None:
        ridx = np.asarray(idx, np.int32).reshape(T, k)
    it, wt = torch.from_numpy(ridx), torch.from_numpy(w)
    got = tile_gather(xt, pt, it, wt)
    assert got.shape == (T, d) and got.dtype == torch.bfloat16
    ij, wj = jnp.asarray(ridx), jnp.asarray(w)
    _two_ulps(got, ref_ref.gather_swiglu_q(xj, qt, ij, wj))
    _two_ulps(got, ref.gather_swiglu_q(xt, pt, it, wt))
    if T:
        _two_ulps(got, K_dm.gather_swiglu_q(xj, qt, ij, wj, interpret=True))


@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_tile_arithmetic_grouped_vs_reference(case):
    sizes = GROUPED_CASES[case]
    d, f, E, T = 24, 32, len(sizes), sum(sizes)
    (xj, xt), qt, pt, _, _ = _qinputs(max(T, 1), d, f, E, 2, "bfloat16", E)
    xj, xt = xj[:T], xt[:T]
    gs = np.asarray(sizes, np.int32)
    got = tile_grouped(xt, pt, torch.from_numpy(gs))
    assert got.shape == (T, d) and got.dtype == torch.bfloat16
    _two_ulps(got, ref_ref.grouped_swiglu_q(xj, qt, jnp.asarray(gs)))
    _two_ulps(got, ref.grouped_swiglu_q(xt, pt, torch.from_numpy(gs)))
    if T:
        _two_ulps(got, K_gm.grouped_swiglu_q(xj, qt, jnp.asarray(gs),
                                             block_t=16, block_f=f,
                                             interpret=True))


@pytest.mark.parametrize("k", [2, 8])
def test_tile_gather_rows_equal_tile_grouped_rows_bitwise(k):
    """Both int8 kernels run one tile routine on one plan: a pair's row from
    the gather form is the grouped form's row for the same (row, expert)."""
    T, d, f, E = 6, 32, 48, 8
    (_, x), _, pt, idx, _ = _qinputs(T, d, f, E, k, "bfloat16", 7)
    flat = torch.from_numpy(idx).reshape(-1).long()
    rows = tile_rows(x.repeat_interleave(k, dim=0), pt, flat)
    order = torch.argsort(flat, stable=True)
    ys = tile_grouped(x[order // k], pt, torch.bincount(flat, minlength=E))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k)
    assert torch.equal(rows, ys[inv])


def test_tile_arithmetic_keeps_h_near_fp32():
    """With h kept as hi + lo the tile is closer to the plain version (h fp32)
    than the same arithmetic with h rounded once to bf16, on these inputs."""
    (_, x), _, pt, idx, _ = _qinputs(16, 64, 96, 4, 1, "bfloat16", 11)
    eid = torch.from_numpy(idx[:, 0]).long()
    order = torch.argsort(eid, stable=True)
    want = ref.grouped_swiglu_q(x[order], pt, torch.bincount(eid, minlength=4))
    got = tile_rows(x[order], pt, eid[order])
    xf = x[order].to(F32)[:, None]
    e = eid[order]
    g = torch.bmm(xf, pt.wg[e].to(F32))[:, 0] * pt.wg_scale[e][:, 0]
    u = torch.bmm(xf, pt.wu[e].to(F32))[:, 0] * pt.wu_scale[e][:, 0]
    h16 = (F.silu(g) * u).to(torch.bfloat16).to(F32)[:, None]
    y16 = (torch.bmm(h16, pt.wd[e].to(F32))[:, 0]
           * pt.wd_scale[e][:, 0]).to(torch.bfloat16)
    gap = (got.to(F32) - want.to(F32)).abs().sum()
    gap16 = (y16.to(F32) - want.to(F32)).abs().sum()
    assert gap < gap16


# ---------------------------------------------------------------------------
# the hi / lo split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e3),
                                        (3, 1e-20), (4, 1e20), (5, 7.5)])
def test_hi_lo_split_keeps_16_bits(seed, scale):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy((rng.standard_normal(4096) * scale)
                         .astype(np.float32))
    hi, lo = split_hi_lo(h)
    err = (h.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * h.double().abs()).all())
    # lo is at most half an ulp of hi
    assert bool((lo.double().abs() <= 2.0 ** -8 * hi.double().abs()).all())


def test_hi_lo_split_is_exact_on_bf16_numbers():
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)).to(
        torch.bfloat16).to(F32)
    hi, lo = split_hi_lo(h)
    assert torch.equal(hi.to(F32), h)
    assert bool((lo == 0).all())


# ---------------------------------------------------------------------------
# routes and plan
# ---------------------------------------------------------------------------

ROUTE_Q_CASES = [(torch.bfloat16, 2048, 768, "tensor_core"),
                 (torch.bfloat16, 7168, 2048, "tensor_core"),
                 (torch.bfloat16, 64, 32, "tensor_core"),
                 (torch.bfloat16, 16, 16, "tensor_core"),
                 (torch.bfloat16, 24, 32, "cuda_core"),
                 (torch.bfloat16, 32, 24, "cuda_core"),
                 (torch.bfloat16, 23, 31, "cuda_core"),
                 (torch.float32, 2048, 768, "cuda_core"),
                 (torch.float32, 24, 32, "cuda_core")]


@pytest.mark.parametrize("dtype,d,f,want", ROUTE_Q_CASES)
def test_route_q_is_a_function_of_dtype_and_widths(dtype, d, f, want):
    before = ops.route_launch_counts()
    assert moe_tc.route_q(dtype, d, f) == want
    assert ops.route_launch_counts() == before
    # a width the int8 tiles refuse may still suit the bf16 ones
    if want == "tensor_core":
        assert moe_tc.route(dtype, d, f) == "tensor_core"


def test_route_q_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        moe_tc.route_q(torch.float16, 2048, 768)


def test_plan_q_is_plan_with_the_int8_ring_depth():
    assert list(inspect.signature(moe_tc.plan_q).parameters) == [
        "d", "f", "n_sms"]
    p, q = moe_tc.plan(2048, 768, 132), moe_tc.plan_q(2048, 768, 132)
    assert q.stages == moe_tc.STAGES_Q
    assert q.args()[:4] == p.args()[:4]
    assert q.k_tiles(2048) == p.k_tiles(2048)
    src = (_build.CSRC / "moe_tc_sm90.cuh").read_text()
    assert moe_tc.STAGES_Q == int(
        re.search(r"constexpr int kStagesQ = (\d+);", src).group(1))
    for name in ("gather_swiglu_q.cu", "grouped_swiglu_q.cu"):
        text = (_build.CSRC / name).read_text()
        assert '#include "moe_tc_sm90.cuh"' in text
        assert "_q_tc_launch" in text


# ---------------------------------------------------------------------------
# the wrappers: one route, counted by it
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes its
    launch path (against a stubbed launcher: nothing runs)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def stub_launch(monkeypatch):
    """Stub the card out of the int8 wrappers: ``_common.launcher`` returns a
    C function that records its symbol, its source and its arguments and
    returns 0 (launched); the SM count is 132 and the stream null."""
    calls = []

    def launcher(symbol, n_ptr, n_int, tail=(), source=None):
        def fn(*args):
            assert len(args) == n_ptr + n_int + len(tail) + 1
            calls.append(dict(symbol=symbol, source=source, n_ptr=n_ptr,
                              args=args))
            return 0
        return fn
    monkeypatch.setattr(_common, "launcher", launcher)
    monkeypatch.setattr(_common, "n_sms", lambda device: 132)
    monkeypatch.setattr(_common, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    return calls


def _tables(d, f, E=1):
    i8 = dict(dtype=torch.int8)
    return Q.QuantizedExpertTables(
        torch.zeros((E, d, f), **i8), torch.zeros((E, d, f), **i8),
        torch.zeros((E, f, d), **i8), torch.ones((E, 1, f)),
        torch.ones((E, 1, f)), torch.ones((E, 1, d)))


@pytest.mark.parametrize("dtype,d,f,want", ROUTE_Q_CASES)
@pytest.mark.parametrize("wrapper", ["gather_swiglu_q_rows", "gather_swiglu_q",
                                     "grouped_swiglu_q"])
def test_int8_wrappers_take_the_one_route_and_count_by_it(stub_launch, wrapper,
                                                          dtype, d, f, want):
    """Each int8 wrapper launches the entry point of ``route_q(dtype, d, f)``
    (on the tensor-core route with ``plan_q``'s tiles), once, and counts that
    launch under that route and nowhere else; the combined gather hands both
    routes w and the [T, d] result it returns (the combine pass on the
    card)."""
    T, k = 3, 2
    x = torch.zeros((T, d), dtype=dtype).as_subclass(_OnCard)
    qt = _tables(d, f)
    module = grouped_mlp if wrapper.startswith("grouped") else decode_moe
    kern = module.GROUPED_Q if module is grouped_mlp else module.GATHER_Q
    before = dict(kern.ROUTE_LAUNCHES)
    n_before = kern.LAUNCHES
    w = torch.full((T, k), 0.5)
    if module is grouped_mlp:
        got = grouped_mlp.grouped_swiglu_q(x, qt, torch.tensor([T]))
    elif wrapper == "gather_swiglu_q":
        got = decode_moe.gather_swiglu_q(x, qt, torch.zeros((T, k)).int(), w)
    else:
        got = decode_moe.gather_swiglu_q_rows(x, qt,
                                              torch.zeros((T, k)).int())
    assert [c["symbol"] for c in stub_launch] == [module.ENTRY_Q[want]]
    call = stub_launch[0]
    assert kern.LAUNCHES == n_before + 1
    assert kern.ROUTE_LAUNCHES == {r: before[r] + (r == want)
                                   for r in moe_tc.ROUTES}
    ints = list(call["args"][call["n_ptr"]:-1])
    if want == "tensor_core":
        assert call["source"] == module.ENTRY_Q[want][:-len("_tc_launch")]
        assert ints[-5:] == list(moe_tc.plan_q(d, f, 132).args())
    else:
        assert ints[-1] == _common.DTYPE_CODES[dtype]
    if wrapper.startswith("gather"):
        assert got.shape == ((T, d) if wrapper == "gather_swiglu_q"
                             else (T, k, d))
        # w and out are the 9th pointer and the last one
        ptrs = call["args"][:call["n_ptr"]]
        combined = wrapper == "gather_swiglu_q"
        assert (ptrs[8] is not None) == combined
        assert (ptrs[-1] == got.data_ptr()) if combined else ptrs[-1] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gather_swiglu_q", "grouped_swiglu_q"])
def test_int8_cpu_path_counts_no_launch_on_any_route(name, dtype):
    kern = ops.KERNELS[name]
    before = dict(kern.ROUTE_LAUNCHES)
    (_, x), _, pt, idx, w = _qinputs(3, 32, 16, 2, 2, dtype, 1)
    if name == "gather_swiglu_q":
        y = ops.gather_swiglu_q(x, pt, torch.from_numpy(idx),
                                torch.from_numpy(w))
    else:
        y = ops.grouped_swiglu_q(x, pt, torch.tensor([1, 2]))
    assert y.shape == x.shape and y.dtype == x.dtype
    assert kern.ROUTE_LAUNCHES == before


# ---------------------------------------------------------------------------
# the combine pass
# ---------------------------------------------------------------------------

def combine_kernel_arith(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``combine_kernel``: acc = 0; acc = fl(acc + fl(w[t, j] * y[t, j])) for
    j ascending, in float32."""
    acc = np.zeros((y.shape[0], y.shape[2]), np.float32)
    for j in range(y.shape[1]):
        prod = np.multiply(w[:, j, None], y[:, j], dtype=np.float32)
        acc = np.add(acc, prod, dtype=np.float32)
    return acc


@pytest.mark.parametrize("T,k,d,seed", [(8, 8, 64, 0), (1, 1, 16, 1),
                                        (5, 3, 40, 2), (8, 2, 128, 3),
                                        (3, 8, 24, 4), (0, 8, 16, 5)])
def test_combine_pass_arithmetic_is_combine_in_order(T, k, d, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy((rng.standard_normal((T, k, d)) * 30).astype(
        np.float32)).to(torch.bfloat16)
    w = rng.random((T, k)).astype(np.float32)
    w = w / w.sum(-1, keepdims=True) if T else w
    want = ref.combine_in_order(y, torch.from_numpy(w))
    got = combine_kernel_arith(y.to(F32).numpy(), w)
    assert want.dtype == F32
    assert np.array_equal(got, want.numpy())
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16),
                       want.to(torch.bfloat16))
