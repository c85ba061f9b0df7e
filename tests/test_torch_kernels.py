"""The port's plain ``gather_swiglu`` / ``grouped_swiglu`` (what its CPU path
runs and what its CUDA kernels are held against on the card) versus the
reference: the jnp oracles in ``repro.kernels.ref`` and the Pallas kernel
bodies in interpret mode, on the same numpy inputs, over the case list of
``tests/test_kernels.py``.

Tolerances. fp32: the only difference is the order of the fp32 sums, so
``rtol=1e-4`` with ``atol`` scaled to the outputs (the reference's own
interpret-vs-oracle gap is 1.8e-4 absolute on N(0,1) weights). bf16: the
reference's CPU oracle rounds the gate/up products to bf16 before the
activation while the kernels (Pallas and CUDA) and the port's plain version
keep them fp32, so results may differ by a rounding of h and of the output:
a few bf16 ulps of the output scale against the oracle, one ulp against
the interpret-mode kernel where the arithmetic is the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import decode_moe, grouped_mlp, ops, ref

from _torch_port import no_activation_mesh  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a.astype(jnp.float32))


def _close(got, want, dtype, ulps=1):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6) if want.size else 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        # one bf16 ulp at the output's scale is 2^-8 of it
        np.testing.assert_allclose(got, want, rtol=0, atol=ulps * scale / 128)


def _tables(rng, E, d, f, dtype, live=None):
    wg = rng.standard_normal((E, d, f)) * 0.2
    wu = rng.standard_normal((E, d, f)) * 0.2
    wd = rng.standard_normal((E, f, d)) * 0.2
    if live is not None:                      # hetero pad rows: zero tables
        wg[live:], wu[live:], wd[live:] = 0, 0, 0
    return [_both(w, dtype) for w in (wg, wu, wd)]


# ---------------------------------------------------------------------------
# grouped
# ---------------------------------------------------------------------------

GROUPED_CASES = {
    "empty-middle": [10, 0, 37, 17],
    "single-expert": [64],
    "tiny-and-dominant": [1, 1, 1, 1, 60],
    "block-aligned": [16, 16, 16, 16],
    "empty-first": [0, 10],
    "empty-last": [10, 0],
    "leading-empties": [0, 0, 16],
    "trailing-empties": [5, 0, 0, 0],
    "empty-run-middle": [3, 0, 0, 3],
    "all-but-one-empty": [0, 0, 0, 0, 64],
    "post-merge": [40, 0, 24, 0, 16, 0, 8, 0],
    "T-zero": [0, 0, 0, 0],
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GROUPED_CASES))
def test_grouped_swiglu_vs_reference(case, dtype):
    sizes = GROUPED_CASES[case]
    rng = np.random.default_rng(len(case))
    d, f, E, T = 24, 32, len(sizes), sum(sizes)
    xj, xt = _both(rng.standard_normal((T, d)) * 0.5, dtype)
    (gj, gt), (uj, ut), (dj, dt_) = _tables(rng, E, d, f, dtype)
    got = ops.grouped_swiglu(xt, gt, ut, dt_, torch.tensor(sizes))
    assert got.shape == (T, d) and got.dtype == xt.dtype
    gs = jnp.asarray(sizes, jnp.int32)
    _close(got, ref_ref.grouped_swiglu(xj, gj, uj, dj, gs), dtype, ulps=4)
    _close(got, ref_ops.grouped_swiglu(xj, gj, uj, dj, gs, interpret=True),
           dtype, ulps=1)


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

GATHER_CASES = {
    # name: (T, d, f, E, k, idx override, live)
    "decode-shape": (4, 24, 32, 8, 2, None, None),
    "single-token-single-expert": (1, 16, 16, 4, 1, None, None),
    "k3": (8, 32, 48, 8, 3, None, None),
    "tiny-table": (3, 16, 32, 2, 2, None, None),
    "duplicate-ids": (2, 16, 16, 4, 2, [[1, 1], [2, 0]], None),
    "out-of-range-ids": (2, 16, 16, 4, 2, [[7, 0], [1, -7]], None),
    "hetero-pad-rows": (4, 24, 32, 8, 2, None, 5),
    "T-zero": (0, 16, 16, 4, 2, None, None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_swiglu_vs_reference(case, dtype):
    T, d, f, E, k, idx, live = GATHER_CASES[case]
    rng = np.random.default_rng(len(case))
    xj, xt = _both(rng.standard_normal((T, d)) * 0.5, dtype)
    (gj, gt), (uj, ut), (dj, dt_) = _tables(rng, E, d, f, dtype, live=live)
    idx = (rng.integers(0, live or E, (T, k)) if idx is None
           else np.asarray(idx)).astype(np.int32).reshape(T, k)
    w = rng.standard_normal((T, k)).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    got = ops.gather_swiglu(xt, gt, ut, dt_, torch.from_numpy(idx),
                            torch.from_numpy(w))
    assert got.shape == (T, d) and got.dtype == xt.dtype
    assert torch.isfinite(got.float()).all()
    ij, wj = jnp.asarray(idx), jnp.asarray(w)
    _close(got, ref_ref.gather_swiglu(xj, gj, uj, dj, ij, wj), dtype, ulps=4)
    if T:    # the Pallas body needs a non-empty grid; its wrapper handles T=0
        _close(got, ref_ops.gather_swiglu(xj, gj, uj, dj, ij, wj,
                                          interpret=True), dtype, ulps=1)


def test_gather_duplicate_expert_sums_weights():
    """A token whose top-k selects the SAME expert twice weights it by the
    sum: the post-merge remap situation."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    wg, wu = (torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(
        np.float32) * 0.2) for _ in range(2))
    wd = torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(
        np.float32) * 0.2)
    y = ref.gather_swiglu(x, wg, wu, wd, torch.tensor([[1, 1]]),
                          torch.tensor([[0.3, 0.7]]))
    one = ref.grouped_swiglu(x, wg[1:2], wu[1:2], wd[1:2], torch.tensor([1]))
    np.testing.assert_allclose(y.numpy(), one.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [2, 8])
def test_gather_equals_sorted_grouped_composition_bitwise(k, dtype):
    """gather(x, idx, w) == sort by expert, grouped, unsort, add the k rows
    in slot order: BITWISE in the port's plain versions at any k (one batched
    product per row, one ordered combine), the contract its CUDA kernels are
    built to keep on the card."""
    rng = np.random.default_rng(3)
    T, d, f, E = 6, 24, 32, 8
    _, x = _both(rng.standard_normal((T, d)) * 0.5, dtype)
    (_, wg), (_, wu), (_, wd) = _tables(rng, E, d, f, dtype)
    idx = torch.from_numpy(rng.integers(0, E, (T, k)))
    w = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, k)).astype(np.float32)), -1)
    y = ref.gather_swiglu(x, wg, wu, wd, idx, w)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ys = ref.grouped_swiglu(x[order // k], wg, wu, wd,
                            torch.bincount(flat, minlength=E))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k)
    out = ref.combine_in_order(ys[inv].reshape(T, k, d), w).to(x.dtype)
    assert torch.equal(y, out)


def test_rows_to_experts_is_duplicate_proof():
    gs = torch.tensor([0, 3, 0, 0, 2, 0])
    assert ref.rows_to_experts(gs, 5).tolist() == [1, 1, 1, 4, 4]


@pytest.mark.parametrize("name", ["gather_swiglu", "grouped_swiglu"])
def test_cpu_dispatch_takes_plain_version_and_counts_no_launch(name):
    mod = ops.KERNELS[name]
    before = mod.LAUNCHES
    x = torch.zeros((2, 8))
    t = torch.zeros((2, 8, 8))
    if name == "gather_swiglu":
        ops.gather_swiglu(x, t, t, t, torch.zeros((2, 1), dtype=torch.int32),
                          torch.ones((2, 1)))
    else:
        ops.grouped_swiglu(x, t, t, t, torch.tensor([1, 1]))
    assert mod.LAUNCHES == before
    assert mod.plain is getattr(ref, name)


@pytest.mark.parametrize("wrapper", [decode_moe.gather_swiglu,
                                     grouped_mlp.grouped_swiglu])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The CUDA wrappers never fall back: a CPU tensor raises."""
    x = torch.zeros((2, 8))
    t = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, t, t, t, torch.tensor([1, 1]), *(
            [torch.ones((2, 1))] if wrapper is decode_moe.gather_swiglu
            else []))
