"""MoE layer differentials: routing, remap / live masking, both dispatch
paths and shared experts against the reference (fp32, CPU), the port's own
gather == ragged contract, and the NotImplementedError of expert
parallelism, which waits for a later slice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as RM
from repro_torch import configs
from repro_torch.models import moe as M

from _torch_port import no_activation_mesh  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(dispatch="gather", n_real=None, live=None, shared=0, seed=0,
           gather_max=8):
    """(ref cfg, ref params, port cfg, port module) of one MoE layer with the
    reference's own initialisation."""
    out = []
    for mod in (ref_configs, configs):
        cfg = mod.get(ARCH).reduced().replace(dtype="float32")
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, n_shared_experts=shared,
            gather_max_tokens=gather_max))
        out.append(cfg)
    rcfg, pcfg = out
    p = RM.moe_init(rcfg, jax.random.PRNGKey(seed), n_real=n_real)
    if live is not None:
        E = rcfg.moe.n_experts
        p["live"] = jnp.asarray(live, jnp.int32)
        p["remap"] = jnp.arange(E, dtype=jnp.int32) % live
    mod = M.MoE(pcfg, "cpu", torch.Generator(), n_real=n_real, live=live)
    for name in ("router", "wg", "wu", "wd"):
        getattr(mod, name).copy_(_t(p[name]))
    mod.remap.copy_(_t(p["remap"]))
    mod.live.copy_(_t(p["live"]))
    if shared:
        for name in ("wg", "wu", "wd"):
            getattr(mod.shared, name).copy_(_t(p["shared"][name]))
    return rcfg, p, pcfg, mod


def test_topk_iterative_exact_ties_take_first_index():
    s = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0],
                  [-np.inf, -np.inf, 0.0, -np.inf, 0.0]], np.float32)
    ww, wi = RM._topk_iterative(jnp.asarray(s), 3)
    gw, gi = M._topk_iterative(_t(s), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    assert gi.tolist()[0] == [1, 2, 4] and gi.tolist()[1] == [0, 1, 2]


def test_route_infer():
    rcfg, p, pcfg, mod = _layer()
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    ww, wi = RM.route_infer(rcfg, p, jnp.asarray(x))
    gw, gi = M.route_infer(pcfg, mod, _t(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-5,
                               atol=1e-6)


def test_corrupted_remap_fails_closed():
    """A remap entry pointing at a pad row (>= live) can never be routed
    to, whatever the router prefers: the logit mask survives corruption."""
    rcfg, p, pcfg, mod = _layer(n_real=4, live=3)
    mod.remap.copy_(torch.tensor([0, 3, 1, 3, 2, 3, 0, 1], dtype=torch.int32))
    # make the corrupted experts the router's favourites
    mod.router[:, [1, 3, 5]] += 10.0
    x = np.random.default_rng(1).standard_normal((4, 1, 64)).astype(np.float32)
    _, idx = M.route_infer(pcfg, mod, _t(x))
    assert not set(idx.reshape(-1).tolist()) & {1, 3, 5}
    assert int(mod.remap[idx.long()].max()) < 3
    # pad rows poisoned with NaN must not reach the output
    mod.wg[3:] = float("nan")
    y = M.moe_apply(pcfg, mod, _t(x), need_aux=False).y
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("shape", [(4, 1), (2, 7), (16, 1)],
                         ids=["gather-shaped", "prefill-shaped",
                              "decode-over-gather-max"])
@pytest.mark.parametrize("variant", ["full", "merged", "hetero", "shared"])
def test_moe_apply_vs_reference(variant, shape):
    kw = {"full": {}, "merged": dict(n_real=4), "shared": dict(shared=1),
          "hetero": dict(n_real=4, live=3)}[variant]
    rcfg, p, pcfg, mod = _layer(**kw)
    x = np.random.default_rng(2).standard_normal(
        shape + (64,)).astype(np.float32)
    want = RM.moe_apply(rcfg, p, jnp.asarray(x), need_aux=False).y
    got = M.moe_apply(pcfg, mod, _t(x), need_aux=False)
    assert float(got.aux_loss) == 0.0
    # fp32, reduction order only; atol scaled to the outputs (the reference's
    # init gives O(10) activations here)
    want = np.asarray(want)
    np.testing.assert_allclose(got.y.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_equals_ragged_inside_the_port(dtype):
    """The same decode-shaped call through both dispatches: BITWISE."""
    _, _, pcfg, mod = _layer(n_real=4)
    mod = mod.to(getattr(torch, dtype))
    mod.router.data = mod.router.data.float()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 1, 64)).astype(np.float32)).to(getattr(torch, dtype))
    g = M.moe_apply(pcfg, mod, x, need_aux=False).y
    rag = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch="ragged"))
    r = M.moe_apply(rag, mod, x, need_aux=False).y
    assert torch.equal(g, r)


def test_later_slices_raise():
    """Expert parallelism still belongs to a later slice; routing for
    training / capture, the balance loss, capture and capacity dispatch are
    ported (held against the reference in test_torch_forward.py) and run."""
    _, _, pcfg, mod = _layer()
    x = torch.zeros((1, 1, 64))
    ep = pcfg.replace(moe=dataclasses.replace(pcfg.moe, ep_axis="model",
                                              ep_degree=2))
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        M.moe_apply(ep, mod, x, need_aux=False)
    out = M.moe_apply(pcfg, mod, x, capture=True)
    assert out.expert_inputs is x and out.usage_counts.shape == (8,)
    assert bool(torch.isfinite(M.moe_apply(pcfg, mod, x).aux_loss))
    dense = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch="dense"))
    assert M.moe_apply(dense, mod, x, need_aux=False).y.shape == x.shape
    w, idx, probs = M.route(pcfg, mod, x)
    assert bool(torch.isfinite(M.balance_loss(pcfg, probs, idx)))
