"""The port's full-sequence model API against the reference's, on the
reduced qwen3-moe config with converted parameters: ``route`` /
``balance_loss``, ``moe_apply`` with ``capture`` and the capacity (``dense``)
dispatch, and ``forward`` / ``loss`` / ``forward(capture=True)`` under the
``dense``, ``ragged`` and ``gather`` dispatches, for the full model and the
merged one (split 1 and split 0 with heterogeneous per-layer M).

Tolerances: fp32 differs by the order of fp32 sums only (``rtol 2e-4``,
``atol 2e-5 * max|y|``). bf16 rounds in each framework's own order at every
projection, so a position's logits agree to a few bf16 ulps of their scale
(``atol 0.05 * max|logit|``), except where a near-tie in the router flips a
pick (or, under capacity dispatch, which pick keeps an expert's last slot):
such a position moves discretely, so in bf16 at least 95 % of the positions
must agree to that tolerance, and the loss to 1e-2 relative. Routing ids and
usage counts are compared exactly in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RMD
from repro.models import moe as RM
from repro_torch import convert
from repro_torch.models import model as MD
from repro_torch.models import moe as M

from _torch_port import cfg_pair, ref_tree_numpy
from _torch_port import no_activation_mesh  # noqa: F401


def _pair(kind, dtype, dispatch, seed=0):
    rcfg, pcfg = cfg_pair(kind, dtype, dispatch)
    params = RMD.init(rcfg, jax.random.PRNGKey(seed))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    return rcfg, params, pcfg, model


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale)
        return
    d = got.shape[-1]
    ok = (np.abs(got - want).reshape(-1, d).max(axis=1) <= 0.05 * scale)
    assert ok.mean() >= 0.95, (f"bf16: {ok.mean():.3f} of the positions "
                               f"agree to 0.05 * max|y|")


def _tokens(cfg, B=2, S=40, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dispatch", ["dense", "ragged", "gather"])
@pytest.mark.parametrize("kind", ["full", "merged", "hetero"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_capture_vs_reference(dispatch, kind, dtype):
    rcfg, params, pcfg, model = _pair(kind, dtype, dispatch)
    toks = _tokens(rcfg)
    rl, raux, rcaps = RMD.forward(rcfg, params, {"tokens": jnp.asarray(toks)},
                                  capture=True)
    pl_, paux, pcaps = MD.forward(pcfg, model,
                                  {"tokens": torch.from_numpy(toks)},
                                  capture=True)
    assert pl_.dtype == torch.float32 and pl_.shape == rl.shape
    _close(pl_, rl, dtype)
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-3)
    (px, pc), (rx, rc) = pcaps, rcaps
    assert px.shape == rx.shape and pc.shape == rc.shape
    assert px.shape[0] == rcfg.n_layers
    _close(px, rx, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    else:
        assert float(pc.sum()) == float(np.asarray(rc).sum())
    rloss, rmet = RMD.loss(rcfg, params, {"tokens": jnp.asarray(toks)})
    ploss, pmet = MD.loss(pcfg, model, {"tokens": torch.from_numpy(toks)})
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(float(ploss), float(rloss), rtol=rtol)
    np.testing.assert_allclose(float(pmet["ce"]), float(rmet["ce"]), rtol=rtol)
    # no capture: the same logits, no captures
    pl2, _, none = MD.forward(pcfg, model, {"tokens": torch.from_numpy(toks)})
    assert none is None and torch.equal(pl2, pl_)


def _layer(dtype="float32", dispatch="dense", seed=0, kind="full"):
    rcfg, params, pcfg, model = _pair(kind, dtype, dispatch, seed)
    key = "stack" if kind == "full" else "stack_c"
    rp = jax.tree.map(lambda a: a[0], params[key])["moe"]
    return rcfg, rp, pcfg, getattr(model, key)[0].moe


def _x(cfg, B=2, S=40, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", ["full", "hetero"])
def test_route_and_balance_loss_vs_reference(kind):
    rcfg, rp, pcfg, mod = _layer(kind=kind)
    x = _x(rcfg)
    rw, ridx, rprobs = RM.route(rcfg, rp, jnp.asarray(x))
    pw, pidx, pprobs = M.route(pcfg, mod, torch.from_numpy(x))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pprobs.numpy(), np.asarray(rprobs), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        float(M.balance_loss(pcfg, pprobs, pidx)),
        float(RM.balance_loss(rcfg, rprobs, ridx)), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["dense", "ragged", "gather"])
@pytest.mark.parametrize("S", [1, 40])
def test_moe_apply_capture_vs_reference(dispatch, S):
    rcfg, rp, pcfg, mod = _layer(dispatch=dispatch)
    x = _x(rcfg, S=S)
    r = RM.moe_apply(rcfg, rp, jnp.asarray(x), capture=True)
    p = M.moe_apply(pcfg, mod, torch.from_numpy(x), capture=True)
    _close(p.y, r.y, "float32")
    np.testing.assert_allclose(float(p.aux_loss), float(r.aux_loss), rtol=1e-5)
    np.testing.assert_array_equal(p.expert_inputs.numpy(),
                                  np.asarray(r.expert_inputs))
    np.testing.assert_array_equal(p.usage_counts.numpy(),
                                  np.asarray(r.usage_counts))
    np.testing.assert_array_equal(p.topk_idx.numpy(), np.asarray(r.topk_idx))


def test_dense_dispatch_drops_what_the_reference_drops():
    """Capacity dispatch with tokens past an expert's capacity: a group of
    64 tokens (C = 20 per expert at top-2 of 8 experts) routed mostly onto
    two experts must drop the same (token, pick) pairs as the reference. The
    dropped tokens' rows differ from the dropless (ragged) result."""
    rcfg, rp, pcfg, mod = _layer()
    x = _x(rcfg, B=2, S=48, seed=4)
    router = np.asarray(rp["router"]).copy()
    router[:, :2] += 3.0 * np.abs(router).max()           # a skewed router
    rp = dict(rp, router=jnp.asarray(router))
    mod.router.copy_(torch.from_numpy(router))
    r = RM.moe_apply(rcfg, rp, jnp.asarray(x), need_aux=False)
    p = M.moe_apply(pcfg, mod, torch.from_numpy(x), need_aux=False)
    _close(p.y, r.y, "float32")
    rag = pcfg.replace(moe=dataclasses.replace(pcfg.moe, dispatch="ragged"))
    dropless = M.moe_apply(rag, mod, torch.from_numpy(x), need_aux=False).y
    assert not torch.allclose(p.y, dropless, atol=1e-3)
    G = min(pcfg.moe.group_size, x.shape[0] * x.shape[1])
    assert M._capacity(pcfg.moe, G, 8) == 20


def test_capacity_experts_sizes_by_the_smallest_live_count():
    rcfg, rp, pcfg, mod = _layer(kind="hetero")
    assert M.capacity_experts(pcfg, mod) == RM.capacity_experts(rcfg, rp) == 3
