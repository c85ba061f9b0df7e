"""The tensor-core route of the bf16 MoE kernels, and the dense MLP's
``round_gu`` option, on the CPU.

* ``kernels/moe_tc.py``: the tile plan is a function of (d, f, SM count)
  only, its k-tiles partition d and f and its column tiles cover f and d, its
  constants are the ``.cu`` header's; the route is one function of
  (dtype, d, f) for both kernels and launches nothing;
* the expert-major pair order of the tensor-core ``gather_swiglu`` (a Python
  mirror of ``csrc/gather_swiglu.cu :: for_each_pair_tile``) is the stable
  sort of ``models/moe.py :: _moe_ragged``, over duplicate, out-of-range and
  merged (``remap``) ids, so a pair meets its expert's tables in the same
  order on both dispatches;
* ``ref.swiglu_mlp(..., round_gu=True)`` is the model's MLP arithmetic: the
  port's CPU ``mlp_apply`` and the reference's JAX ``mlp_apply`` in bf16 (two
  bf16 ulps at the output's scale, the tolerance of
  ``test_torch_swiglu.py::test_mlp_apply_on_cpu_is_the_reference_model_
  arithmetic``: the reference's bf16 silu rounds in other places than
  PyTorch's), and the identity in fp32; ``ops.swiglu_mlp`` keeps the kernel
  contract (g and u in fp32).

The kernels themselves are held against their plain versions on the card by
``chip_smoke.py`` (they cannot run here).
"""
import dataclasses
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels import _build, decode_moe, grouped_mlp, moe_tc, ops
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import moe as M

from _torch_port import no_activation_mesh  # noqa: F401

#: (d, f) of the MoE configs the port serves, reduced and full, and widths of
#: 8 times an odd number (ragged k- and column tiles)
MOE_WIDTHS = [(2048, 768), (7168, 2048), (4096, 1536), (64, 32), (24, 32),
              (8 * 45, 8 * 131)]


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

def test_plan_never_reads_the_token_count_k_or_the_groups():
    assert list(inspect.signature(moe_tc.plan).parameters) == [
        "d", "f", "n_sms"]
    assert {f.name for f in dataclasses.fields(moe_tc.Plan)} == {
        "m_tile", "up_n_tile", "down_n_tile", "k_tile", "stages"}
    assert moe_tc.plan(2048, 768, 132) == moe_tc.plan(2048, 768, 132)


def test_plan_constants_are_the_kernels():
    src = (_build.CSRC / "moe_tc_sm90.cuh").read_text()
    assert (moe_tc.M_TILE, moe_tc.UP_N_TILE, moe_tc.DOWN_N_TILE,
            moe_tc.K_TILE, moe_tc.STAGES) == tuple(
        _constexpr(src, n) for n in ("kBM", "kUpBN", "kDownBN", "kBK",
                                     "kStages"))
    # one warpgroup's wgmma rows; both column tiles are wgmma widths
    assert moe_tc.M_TILE == 64
    assert {moe_tc.UP_N_TILE, moe_tc.DOWN_N_TILE} <= {64, 128}
    assert moe_tc.K_TILE % 16 == 0 and moe_tc.STAGES >= 3
    for name in ("gather_swiglu.cu", "grouped_swiglu.cu"):
        assert '#include "moe_tc_sm90.cuh"' in (_build.CSRC / name).read_text()


@pytest.mark.parametrize("n_sms", [1, 114, 132])
@pytest.mark.parametrize("d,f", MOE_WIDTHS)
def test_plan_k_tiles_partition_and_column_tiles_cover(d, f, n_sms):
    p = moe_tc.plan(d, f, n_sms)
    for width in (d, f):
        steps = p.k_tiles(width)
        assert steps[0][0] == 0 and steps[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(steps, steps[1:]))
        assert all(0 < hi - lo <= p.k_tile for lo, hi in steps)
        assert all(lo % p.k_tile == 0 for lo, _ in steps)
    for width, n_tile in ((f, p.up_n_tile), (d, p.down_n_tile)):
        cols = p.column_tiles(width, n_tile)
        assert cols[0][0] == 0 and cols[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
        assert len(cols) == -(-width // n_tile)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

ROUTE_CASES = [(torch.bfloat16, 2048, 768, "tensor_core"),
               (torch.bfloat16, 24, 32, "tensor_core"),
               (torch.bfloat16, 23, 31, "cuda_core"),
               (torch.bfloat16, 2048, 764, "cuda_core"),
               (torch.bfloat16, 2044, 768, "cuda_core"),
               (torch.float32, 2048, 768, "cuda_core"),
               (torch.float32, 23, 31, "cuda_core")]


@pytest.mark.parametrize("dtype,d,f,want", ROUTE_CASES)
def test_route_is_a_function_of_dtype_and_widths(dtype, d, f, want):
    before = ops.launch_counts()
    assert moe_tc.route(dtype, d, f) == want
    assert ops.launch_counts() == before


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        moe_tc.route(torch.float16, 2048, 768)


@pytest.mark.parametrize("kernel,module", [
    (decode_moe.GATHER, decode_moe), (grouped_mlp.GROUPED, grouped_mlp)])
def test_both_kernels_take_the_one_route_and_count_by_it(kernel, module):
    assert tuple(kernel.ROUTE_LAUNCHES) == moe_tc.ROUTES
    assert set(module.ENTRY) == set(moe_tc.ROUTES)
    wrapper = getattr(module, kernel.name)
    body = inspect.getsource(wrapper)
    assert "moe_tc.route(x.dtype, d, f)" in body
    assert f"{kernel.name.upper().split('_')[0]}.count(path)" in body


# ---------------------------------------------------------------------------
# the expert-major pair order of the tensor-core gather
# ---------------------------------------------------------------------------

def expert_major_tiles(idx, E, m_tile=moe_tc.M_TILE, threads=128):
    """A mirror of ``for_each_pair_tile``: for each expert e, the ids are
    walked ``threads`` at a time, the pairs whose clipped id is e appended in
    ascending order, and a tile of ``m_tile`` runs whenever that many are
    held (the rest at the end). Returns {e: [tile, ...]}."""
    flat = np.clip(np.asarray(idx).reshape(-1), 0, E - 1)
    out = {}
    for e in range(E):
        held, tiles = [], []
        for base in range(0, flat.size, threads):
            chunk = flat[base:base + threads]
            held += [base + i for i in np.nonzero(chunk == e)[0]]
            while len(held) >= m_tile:
                tiles.append(held[:m_tile])
                held = held[m_tile:]
        if held:
            tiles.append(held)
        out[e] = tiles
    return out


def _ids(case, rng):
    """(idx [T, k], E) of a decode step: model-like routing onto E experts,
    duplicates, out-of-range ids, a merged remap, one expert for everyone."""
    if case == "model":
        T, k, E = 8, 8, 128
        return np.argsort(rng.random((T, E)), -1)[:, :k], E
    if case == "duplicates":
        return np.array([[1, 1, 3], [2, 0, 1], [1, 1, 1]]), 4
    if case == "out-of-range":
        return np.array([[7, 0], [1, -7], [-1, 9], [3, 3]]), 4
    if case == "merged-remap":
        T, k, N, Mx = 8, 8, 128, 64
        remap = np.arange(N) % Mx
        return remap[np.argsort(rng.random((T, N)), -1)[:, :k]], Mx
    if case == "one-expert-two-tiles":
        return np.full((40, 4), 5), 8
    raise AssertionError(case)


ID_CASES = ["model", "duplicates", "out-of-range", "merged-remap",
            "one-expert-two-tiles"]


@pytest.mark.parametrize("case", ID_CASES)
def test_expert_major_order_is_the_ragged_stable_sort(case):
    idx, E = _ids(case, np.random.default_rng(0))
    tiles = expert_major_tiles(idx, E)
    order = [p for e in range(E) for t in tiles[e] for p in t]
    flat = torch.from_numpy(np.asarray(idx).reshape(-1)).long()
    want = torch.argsort(flat.clamp(0, E - 1), stable=True).tolist()
    assert order == want
    for e, ts in tiles.items():
        assert all(len(t) == moe_tc.M_TILE for t in ts[:-1])
        assert all(0 < len(t) <= moe_tc.M_TILE for t in ts)
    if case == "one-expert-two-tiles":
        assert [len(t) for t in tiles[5]] == [64, 64, 32]


@pytest.mark.parametrize("case", ["model", "out-of-range", "merged-remap"])
def test_ragged_dispatch_feeds_rows_in_the_expert_major_order(case,
                                                              monkeypatch):
    """``_moe_ragged`` hands the grouped kernel the rows of each expert's
    pairs in the gather kernel's pair order, with the group sizes of its
    tiles."""
    idx, E = _ids(case, np.random.default_rng(1))
    T, k = idx.shape
    d = 16
    x = torch.arange(T, dtype=torch.float32)[:, None].repeat(1, d)
    seen = {}

    def grouped(xs, wg, wu, wd, group_sizes):
        seen["xs"], seen["gs"] = xs.clone(), group_sizes.clone()
        return torch.zeros_like(xs)

    monkeypatch.setattr(M.kops, "grouped_swiglu", grouped)
    p = type("P", (), {})()
    p.wg = p.wu = p.wd = torch.zeros((E, d, 8))
    monkeypatch.setattr(M, "n_real_experts", lambda _: E)
    monkeypatch.setattr(M, "_quant_tables", lambda _: None)
    M._moe_ragged(None, p, x, torch.ones((T, k)),
                  torch.from_numpy(np.asarray(idx)).to(torch.int32))
    tiles = expert_major_tiles(idx, E)
    order = [q for e in range(E) for t in tiles[e] for q in t]
    assert seen["xs"][:, 0].long().tolist() == [q // k for q in order]
    assert seen["gs"].tolist() == [sum(map(len, tiles[e])) for e in range(E)]


# ---------------------------------------------------------------------------
# C6: the dense MLP's round_gu option
# ---------------------------------------------------------------------------

def _mlp_inputs(T, d, f, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((T, d)) * 0.5,
            rng.standard_normal((d, f)) / d ** 0.5,
            rng.standard_normal((d, f)) / d ** 0.5,
            rng.standard_normal((f, d)) / f ** 0.5]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = [jnp.asarray(a.astype(np.float32), jd) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _two_ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale / 64)


@pytest.mark.parametrize("T,d,f", [(18, 64, 128), (5, 48, 200)])
def test_round_gu_is_the_model_arithmetic_in_bf16(T, d, f):
    (jx, jwg, jwu, jwd), (x, wg, wu, wd) = _mlp_inputs(T, d, f, "bfloat16",
                                                        seed=T)
    got = ref.swiglu_mlp(x, wg, wu, wd, round_gu=True)
    mod = L.MLP(d, f, torch.bfloat16, "cpu", torch.Generator())
    for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
        getattr(mod, name).copy_(w)
    _two_ulps(got.float(), L.mlp_apply(mod, x).float())
    want = RL.mlp_apply(dict(wg=jwg, wu=jwu, wd=jwd), jx)
    _two_ulps(got.float(), np.asarray(want.astype(jnp.float32)))
    # the option changes the arithmetic: g and u rounded, silu rounded
    assert not torch.equal(got, ref.swiglu_mlp(x, wg, wu, wd))


@pytest.mark.parametrize("T,d,f,seed", [(16, 64, 128, 0), (7, 96, 80, 1)])
def test_round_gu_is_the_model_arithmetic_on_exact_sums(T, d, f, seed):
    """Inputs on which every fp32 sum is exact in any order (the inputs of
    ``chip_smoke.py :: round_gu_exact``): integer x in [1, 4], gate / up
    weights in {2..5} / 4, so g and u are quarter-integers in [d / 2, 5 d],
    not all bf16 numbers, and silu(g) == g (g >= 32); down weights in
    {-2..2} / 8, so y is an integer below 2^24. There the model's arithmetic
    has one answer, and ``round_gu`` must give it bitwise, as the port's CPU
    ``mlp_apply`` and the reference's JAX ``mlp_apply`` do; the kernel
    contract (g and u in fp32) must not."""
    rng = np.random.default_rng(seed)

    def ints(shape, lo, hi, scale):
        return rng.integers(lo, hi + 1, shape).astype(np.float32) / scale
    arrs = [ints((T, d), 1, 4, 1), ints((d, f), 2, 5, 4),
            ints((d, f), 2, 5, 4), ints((f, d), -2, 2, 8)]
    x, wg, wu, wd = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jx, jwg, jwu, jwd = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    got = ref.swiglu_mlp(x, wg, wu, wd, round_gu=True)
    contract = ref.swiglu_mlp(x, wg, wu, wd, round_gu=False)
    mod = L.MLP(d, f, torch.bfloat16, "cpu", torch.Generator())
    for name, w in (("wg", wg), ("wu", wu), ("wd", wd)):
        getattr(mod, name).copy_(w)
    port = L.mlp_apply(mod, x)
    jax_model = torch.from_numpy(np.array(
        RL.mlp_apply(dict(wg=jwg, wu=jwu, wd=jwd), jx).astype(jnp.float32)))
    assert torch.equal(got, port)
    assert torch.equal(got.float(), jax_model)
    assert not torch.equal(contract, port)


def test_round_gu_is_the_identity_in_fp32():
    _, (x, wg, wu, wd) = _mlp_inputs(9, 32, 48, "float32", seed=3)
    assert torch.equal(ref.swiglu_mlp(x, wg, wu, wd, round_gu=True),
                       ref.swiglu_mlp(x, wg, wu, wd))


def test_ops_swiglu_mlp_keeps_the_kernel_contract():
    """The reference kernel's contract through the dispatch point: g and u
    in fp32 (no ``round_gu``); only the model's MLP asks for the model's
    rounding."""
    _, (x, wg, wu, wd) = _mlp_inputs(12, 64, 96, "bfloat16", seed=4)
    assert "round_gu" not in inspect.signature(ops.swiglu_mlp).parameters
    assert torch.equal(ops.swiglu_mlp(x, wg, wu, wd),
                       ref.swiglu_mlp(x, wg, wu, wd, round_gu=False))
    assert "round_gu=True" in inspect.getsource(L.mlp_apply)
