"""The port's optimizers (``repro_torch.optim``) and int8 error feedback
(``repro_torch.distributed.compression``) against the reference's.

* Each optimizer over 5 steps on the same numpy trees (stacked ``[L, ...]``
  leaves, a 1-D leaf, an integer leaf), the reference jitted: updates,
  parameters and every state leaf in fp32 to a few ulps of each leaf's
  largest entry; the integer leaf is left alone and its state is
  ``{"na"}``. Clipping on and off, a cosine schedule, bf16 parameters.
* The reference's own cases (``tests/test_optim.py``) on the port:
  convergence on a quadratic, adafactor's factored state, integer leaves,
  the clipping bound, the schedule's shape, the size rule.
* ``quantize``: the int8 levels and the scale bitwise the reference's, the
  noise being ``jax.random.uniform`` under threefry keys bit for bit;
  ``ef_compressed`` (leaf index in JAX's flattening, integer leaves
  counted) against the reference's, and the reference's own
  ``tests/test_distributed.py`` cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from repro import optim as R
from repro.distributed import compression as RC
from repro_torch import convert
from repro_torch import optim as P
from repro_torch.core import threefry as TF
from repro_torch.distributed import compression as PC


def _tree(rng, dtype=np.float32):
    """A reference-layout tree: stacked leaves, a 1-D leaf, int leaves."""
    return {
        "embed": {"tok": rng.standard_normal((11, 6)).astype(dtype)},
        "stack": {"attn": {"wq": rng.standard_normal((3, 6, 4)).astype(dtype)},
                  "ln1": {"scale": (1 + 0.1 * rng.standard_normal((3, 6))
                                    ).astype(dtype)},
                  "moe": {"wg": rng.standard_normal((3, 5, 6, 2)).astype(dtype),
                          "remap": np.arange(15, dtype=np.int32).reshape(3, 5),
                          "live": np.full((3,), 5, np.int32)}},
        "final_ln": {"scale": np.ones((6,), dtype)},
    }


def _grads(rng, tree):
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape).astype(np.float32) * 3
                   if np.issubdtype(x.dtype, np.floating) else None), tree)


def _ref_grads(g, tree):
    return jax.tree.map(lambda x, p: (jnp.asarray(x) if x is not None else
                                      np.zeros(p.shape, jax.dtypes.float0)),
                        g, tree, is_leaf=lambda x: x is None)


def _port_grads(g):
    if isinstance(g, dict):
        return {k: _port_grads(v) for k, v in g.items()}
    return None if g is None else torch.from_numpy(np.array(g))


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                             if x.dtype == jnp.bfloat16 else x),
                        tree)


def _close(want, got, ulps=8, what=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            _close(want[k], got[k], ulps, f"{what}.{k}")
        return
    a = np.asarray(want)
    b = got.detach()
    b = (b.float() if b.is_floating_point() else b).numpy()
    assert a.shape == b.shape, what
    if not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    scale = max(float(np.max(np.abs(a))), 1e-30) if a.size else 1.0
    err = float(np.max(np.abs(a.astype(np.float64) - b))) if a.size else 0.0
    assert err <= ulps * np.finfo(np.float32).eps * scale, (what, err, scale)


def _bf16(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16)
                        if np.issubdtype(x.dtype, np.floating)
                        else jnp.asarray(x), tree)


CASES = {
    "adamw": (lambda m: m.adamw(lr=1e-2), lambda m: m.adamw(lr=1e-2)),
    "adamw-no-clip": (lambda m: m.adamw(lr=3e-2, max_grad_norm=0.0),
                      lambda m: m.adamw(lr=3e-2, max_grad_norm=0.0)),
    "adamw-cosine": (
        lambda m: m.adamw(schedule=m.cosine_schedule(1e-2, 2, 5)),
        lambda m: m.adamw(schedule=m.cosine_schedule(1e-2, 2, 5))),
    "adafactor": (lambda m: m.adafactor(lr=1e-2),
                  lambda m: m.adafactor(lr=1e-2)),
    "sgd": (lambda m: m.sgd(lr=1e-2), lambda m: m.sgd(lr=1e-2)),
    "sgd-clip": (lambda m: m.sgd(lr=1e-2, max_grad_norm=1.0),
                 lambda m: m.sgd(lr=1e-2, max_grad_norm=1.0)),
    "ef-adamw": (lambda m: RC.ef_compressed(m.adamw(lr=1e-2), seed=4),
                 lambda m: PC.ef_compressed(m.adamw(lr=1e-2), seed=4)),
    "ef-adafactor": (lambda m: RC.ef_compressed(m.adafactor(lr=1e-2), seed=5),
                     lambda m: PC.ef_compressed(m.adafactor(lr=1e-2), seed=5)),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_reference(case, bf16):
    make_ref, make_port = CASES[case]
    ro, po = make_ref(R), make_port(P)
    rng = np.random.default_rng(len(case) + bf16)
    tree = _tree(rng)
    rp = _bf16(tree) if bf16 else jax.tree.map(jnp.asarray, tree)
    pp = convert.tree_to_torch(_np(rp))
    if bf16:
        pp = jax.tree.map(lambda t: t.to(torch.bfloat16)
                          if t.is_floating_point() else t, pp)
    rs, ps = ro.init(rp), po.init(pp)
    upd = jax.jit(ro.update)
    for step in range(5):
        g = _grads(rng, tree)
        ru, rs = upd(_ref_grads(g, tree), rs, rp, jnp.asarray(step))
        pu, ps = po.update(_port_grads(g), ps, pp, step)
        rp, pp = R.apply_updates(rp, ru), P.apply_updates(pp, pu)
        _close(_np(ru), pu, what=f"u{step}")
        if case.startswith("ef"):
            # each step from the reference's state: its jitted residual
            # ``corrected - q * scale`` may differ from the two roundings by
            # an ulp of ``corrected``, and a later int8 rounding with it
            _close(_np(rs["inner"]), ps["inner"], what=f"state {step}")
            g_max = max(float(np.max(np.abs(x))) for x in
                        jax.tree.leaves(g) if x is not None)
            for a, b in zip(jax.tree.leaves(_np(rs["ef"])),
                            P.optimizers.tree_leaves(ps["ef"])):
                # two ulps of |corrected| <= |g| + |r| < 2 max|g|
                assert np.max(np.abs(a - b.numpy()), initial=0.0) <= (
                    2 * np.finfo(np.float32).eps * 2 * g_max)
            ps = convert.tree_to_torch(_np(rs))
    if bf16:     # a bf16 parameter is its update rounded: equal or one ulp
        for a, b in zip(jax.tree.leaves(_np(rp)), P.optimizers.tree_leaves(pp)):
            np.testing.assert_allclose(a, b.float().numpy(), rtol=2 ** -7)
    else:
        _close(_np(rp), pp, what="params")
    _close(_np(rs), ps, what="state")
    assert torch.equal(pp["stack"]["moe"]["remap"],
                       torch.arange(15, dtype=torch.int32).reshape(3, 5))
    inner = ps["inner"] if "inner" in ps else ps
    assert set(inner["stack"]["moe"]["live"]) == (
        {"_"} if case.startswith("sgd") else {"na"})


# ---------------------------------------------------------------------------
# the reference's own cases, on the port
# ---------------------------------------------------------------------------

def _quadratic():
    target = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]]),
              "b": torch.tensor([0.3, -0.7])}

    def loss(p):
        return sum(float(torch.sum((p[k] - target[k]) ** 2)) for k in p)

    def grad(p):
        return {k: 2 * (p[k] - target[k]) for k in p}
    return loss, grad


@pytest.mark.parametrize("make,steps,lr,tol", [
    (P.adamw, 400, 3e-2, 1e-2), (P.adafactor, 800, 5e-2, 6e-2),
    (P.sgd, 200, 2e-1, 1e-2)])
def test_converges_on_quadratic(make, steps, lr, tol):
    loss, grad = _quadratic()
    params = {"w": torch.zeros((2, 2)), "b": torch.zeros(2)}
    opt = make(lr=lr)
    state = opt.init(params)
    for i in range(steps):
        u, state = opt.update(grad(params), state, params, i)
        params = P.apply_updates(params, u)
    assert loss(params) < tol


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros(32)}
    st = P.adafactor().init(params)
    assert st["w"]["vr"].shape == (64,)
    assert st["w"]["vc"].shape == (32,)
    assert st["b"]["v"].shape == (32,)
    n_state = sum(x.numel() for x in P.optimizers.tree_leaves(st))
    assert n_state < params["w"].numel()


def test_int_params_skipped():
    params = {"w": torch.zeros((4, 4)),
              "remap": torch.arange(4, dtype=torch.int32)}
    opt = P.adamw(lr=0.1)
    state = opt.init(params)
    grads = {"w": 2 * params["w"], "remap": None}
    u, state = opt.update(grads, state, params, 0)
    p2 = P.apply_updates(params, u)
    assert torch.equal(p2["remap"], torch.arange(4, dtype=torch.int32))
    assert p2["remap"].dtype == torch.int32


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = P.sgd(lr=1.0, max_grad_norm=1.0)
    state = opt.init(params)
    u, _ = opt.update({"w": torch.full((4,), 1e6)}, state, params, 0)
    assert float(P.global_norm(u)) <= 1.0 + 1e-5


def test_cosine_schedule_shape():
    lr = P.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 0.11
    assert float(lr(100)) < float(lr(50))
    ref = R.cosine_schedule(1.0, warmup=10, total=100)
    for s in (0, 3, 10, 37, 99, 150):
        assert float(lr(s)) == pytest.approx(float(ref(jnp.asarray(s))),
                                             rel=1e-6)


def test_default_optimizer_thresholds():
    assert P.default_optimizer_for(8e9) == "adamw"
    assert P.default_optimizer_for(110e9) == "adafactor"
    assert P.default_optimizer_for(1e12) == "adafactor"


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    g = _grads(rng, _tree(rng))
    want = float(R.global_norm(jax.tree.map(jnp.asarray, {
        k: v for k, v in g.items()})))
    assert float(P.global_norm(_port_grads(g))) == pytest.approx(want,
                                                                 rel=1e-6)


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed,step,index", [
    ((1000,), 0, 0, 0), ((3, 50), 5, 7, 2), ((2, 8, 64, 32), 9, 2, 11),
    ((4, 1), 1, 123456, 40)])
def test_quantize_is_the_references_bit_for_bit(shape, seed, step, index):
    g = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 3
    rkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 step), index)
    pkey = TF.fold_in(TF.fold_in(TF.prng_key(seed), step), index)
    q1, s1 = jax.jit(RC.quantize)(jnp.asarray(g), rkey)
    q2, s2 = PC.quantize(torch.from_numpy(g), pkey)
    assert q2.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(q1), q2.numpy())
    assert float(s1) == float(s2)
    np.testing.assert_array_equal(np.asarray(RC.dequantize(q1, s1)),
                                  PC.dequantize(q2, s2).numpy())


def test_quantize_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    q, s = PC.quantize(g, TF.prng_key(0))
    err = torch.max(torch.abs(PC.dequantize(q, s) - g))
    assert float(err) <= float(s) + 1e-6          # at most one level


def test_ef_residual_state_present():
    params = {"w": torch.zeros((3, 3)), "remap": torch.arange(3)}
    st = PC.ef_compressed(P.adamw()).init(params)
    assert st["ef"]["w"].shape == (3, 3)
    assert st["ef"]["remap"].shape == ()
    assert "inner" in st


def test_ef_compression_converges_like_uncompressed():
    """Error feedback: the quantization bias cancels over steps."""
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])

    def run(opt, steps=300):
        params = {"w": torch.zeros(4)}
        state = opt.init(params)
        for i in range(steps):
            g = {"w": 2 * (params["w"] - target)}
            u, state = opt.update(g, state, params, i)
            params = P.apply_updates(params, u)
        return float(torch.sum((params["w"] - target) ** 2))

    base = run(P.sgd(lr=0.1))
    comp = run(PC.ef_compressed(P.sgd(lr=0.1)))
    assert comp < 1e-3 and base < 1e-6
    assert run(PC.ef_compressed(P.adamw(lr=3e-2)), steps=400) < 1e-2
