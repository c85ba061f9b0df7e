"""Layer-level differentials: the port's ``models/layers.py`` against the
reference's on the same numpy inputs, fp32 on the CPU. Tolerances are for
fp32 reduction order only (``rtol=1e-5``/``atol=1e-5`` on O(1) values)
unless a test says otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import configs
from repro_torch.models import layers as L

from _torch_port import no_activation_mesh  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    return (ref_configs.get(ARCH).reduced().replace(dtype="float32", **kw),
            configs.get(ARCH).reduced().replace(dtype="float32", **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn(rng, rcfg, pcfg):
    d, hd, nq, nkv = rcfg.d_model, rcfg.hd, rcfg.n_heads, rcfg.n_kv_heads
    w = {"wq": rng.standard_normal((d, nq * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, nkv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, nkv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((nq * hd, d)) / np.sqrt(nq * hd)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    mod = L.Attention(pcfg, "cpu", torch.Generator())
    for k, v in w.items():
        getattr(mod, k).copy_(_t(v))
    return {k: jnp.asarray(v) for k, v in w.items()}, mod


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    mod = L.RMSNorm(64, torch.float32, "cpu")
    mod.scale.copy_(_t(scale))
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(L.rmsnorm(mod, _t(x), 1e-5).numpy(),
                               np.asarray(want), **TOL)


def test_rope_freqs_and_apply_rope():
    rng = np.random.default_rng(1)
    inv_r = RL.rope_freqs(16, 1_000_000.0)
    inv_p = L.rope_freqs(16, 1_000_000.0)
    np.testing.assert_allclose(inv_p.numpy(), np.asarray(inv_r), rtol=1e-6)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [90, 91, 92, 93, 94, 95, 400]],
                   np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv_r)
    got = L.apply_rope(_t(x), _t(pos), inv_p)
    # angles up to 400 rad in fp32: sin/cos implementations differ by ~1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_sdpa_gqa_and_fully_masked_rows_stay_finite():
    rng = np.random.default_rng(2)
    B, Sq, Sk, nq, nkv, hd = 2, 3, 6, 4, 2, 16
    q = rng.standard_normal((B, Sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, nkv, hd)).astype(np.float32)
    mask = rng.random((B, 1, Sq, Sk)) > 0.4
    mask[0, 0, 1, :] = False                      # one fully masked row
    want = RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mask), nq // nkv)
    got = L._sdpa(_t(q), _t(k), _t(v), _t(mask), nq // nkv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # GQA is repeat_interleave (head h reads kv head h // n_rep), not tiling
    tiled = L._sdpa(_t(q), _t(k).repeat(1, 1, 2, 1), _t(v).repeat(1, 1, 2, 1),
                    _t(mask), 1)
    assert not np.allclose(tiled.numpy(), np.asarray(want), atol=1e-3)


def test_attn_prefill():
    rcfg, pcfg = _cfgs()
    rng = np.random.default_rng(3)
    rp, pm = _attn(rng, rcfg, pcfg)
    x = rng.standard_normal((2, 9, rcfg.d_model)).astype(np.float32)
    inv_r = RL.rope_freqs(rcfg.hd, rcfg.rope_theta)
    inv_p = L.rope_freqs(pcfg.hd, pcfg.rope_theta)
    wo, wk, wv = RL.attn_prefill(rcfg, rp, jnp.asarray(x), inv_freq=inv_r)
    go, gk, gv = L.attn_prefill(pcfg, pm, _t(x), inv_freq=inv_p)
    for g, w in ((go, wo), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_attn_decode_slots_and_full_slot_write_is_masked():
    """Per-slot decode vs the reference, with one slot at ``pos == s_max``
    (a frozen slot whose request filled its cache exactly). The reference's
    scatter drops that write; the port must mask it: the call must not
    raise and must leave that slot's cache rows as they were."""
    rcfg, pcfg = _cfgs()
    rng = np.random.default_rng(4)
    rp, pm = _attn(rng, rcfg, pcfg)
    B, S = 3, 8
    x = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, S, rcfg.n_kv_heads, rcfg.hd)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    pos = np.array([2, S, 5], np.int32)           # slot 1 is full
    inv_r = RL.rope_freqs(rcfg.hd, rcfg.rope_theta)
    inv_p = L.rope_freqs(pcfg.hd, pcfg.rope_theta)
    wo, wk, wv = RL.attn_decode_slots(rcfg, rp, jnp.asarray(x),
                                      jnp.asarray(ck), jnp.asarray(cv),
                                      jnp.asarray(pos), inv_freq=inv_r)
    tk, tv = _t(ck), _t(cv)
    go, gk, gv = L.attn_decode_slots(pcfg, pm, _t(x), tk, tv, _t(pos),
                                     inv_freq=inv_p)
    assert gk is tk and gv is tv                  # updated in place
    np.testing.assert_array_equal(gk[1].numpy(), ck[1])
    np.testing.assert_array_equal(gv[1].numpy(), cv[1])
    assert not np.array_equal(gk[0, 2].numpy(), ck[0, 2])
    for g, w in ((go, wo), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_mlp_apply():
    rng = np.random.default_rng(5)
    d, f = 64, 32
    w = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d)))}
    mod = L.MLP(d, f, torch.float32, "cpu", torch.Generator())
    for k, v in w.items():
        getattr(mod, k).copy_(_t(v))
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = RL.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(L.mlp_apply(mod, _t(x)).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(tie_embeddings=True),
                                dict(logits_softcap=5.0)],
                         ids=["untied", "tied", "softcap"])
def test_embed_and_lm_head(kw):
    rcfg, pcfg = _cfgs(**kw)
    rng = np.random.default_rng(6)
    tok = (rng.standard_normal((rcfg.vocab_size, rcfg.d_model)) * 0.5
           ).astype(np.float32)
    head = (rng.standard_normal((rcfg.d_model, rcfg.vocab_size)) * 0.5
            ).astype(np.float32)
    rp = {"tok": jnp.asarray(tok)}
    mod = L.Embed(pcfg, "cpu", torch.Generator())
    mod.tok.copy_(_t(tok))
    if not rcfg.tie_embeddings:
        rp["head"] = jnp.asarray(head)
        mod.head.copy_(_t(head))
    ids = rng.integers(0, rcfg.vocab_size, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        L.embed_apply(mod, _t(ids)).numpy(),
        np.asarray(RL.embed_apply(rp, jnp.asarray(ids))))
    x = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    got = L.lm_head(pcfg, mod, _t(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(RL.lm_head(rcfg, rp, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


def test_lm_head_returns_fp32_from_bf16_operands():
    _, pcfg = _cfgs()
    pcfg = pcfg.replace(dtype="bfloat16")
    mod = L.Embed(pcfg, "cpu", torch.Generator().manual_seed(0))
    x = torch.randn((2, 1, pcfg.d_model), generator=torch.Generator(
    ).manual_seed(1)).to(torch.bfloat16)
    got = L.lm_head(pcfg, mod, x)
    assert got.dtype == torch.float32
    want = x.float() @ mod.head.float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
