"""The Mamba2 block of the port (``repro_torch.models.mamba``) against the
reference's (``repro.models.mamba``) on the same numpy inputs, CPU: the
segment sum, the causal conv, the chunked SSD scan (one and several chunks,
with and without an initial state), the full-sequence block with its decode
state (a sequence a chunk multiple and not), the one-token decode, the zero
states; and C11 (ROADMAP): the reference cannot decode after a prompt
shorter than ``conv_width - 1`` tokens, the port can.

Tolerances: fp32 1e-5 relative (atol 1e-5 of the output's largest
magnitude: the two frameworks sum in their own order); bf16 two bf16 ulps
of max |y| (a one-ulp rounding flip of an intermediate, carried through);
C11's logits against the reference's forward 1e-4 (fp32 logits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba as RS
from repro.models import model as RMD
from repro_torch import configs
from repro_torch.models import mamba as S
from repro_torch.models import model as MD

from _torch_port import no_activation_mesh, one_torch_thread  # noqa: F401
from _torch_port import fast_jit, ref_params, ref_tree_numpy

ARCH = "mamba2-370m"


def _cfgs(dtype="float32", arch=ARCH):
    return (ref_configs.get(arch).reduced().replace(dtype=dtype),
            configs.get(arch).reduced().replace(dtype=dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype="float32"):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    big = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * big)
    else:
        ulp = 2.0 ** (np.floor(np.log2(max(big, 1e-30))) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def _pair(rng, shape, dtype="float32", scale=1.0):
    """(jax, torch) copies of one numpy draw, the torch one the jax array's
    exact values."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j = jnp.asarray(rng.standard_normal(shape) * scale, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.float32 if dtype == "float32" else torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _ref_apply(rcfg):
    """The reference's mamba_apply(return_state=True), jitted once a
    config (one compile instead of one per operation)."""
    return fast_jit(lambda p, x, s0=None: RS.mamba_apply(
        rcfg, p, x, init_state=s0, return_state=True))


@functools.lru_cache(maxsize=None)
def _ref_decode(rcfg):
    return fast_jit(lambda p, x, st: RS.mamba_decode(rcfg, p, x, st))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def block(request):
    """(dtype, ref cfg, ref params of one block, port cfg, port block)."""
    dtype = request.param
    rcfg, pcfg = _cfgs(dtype)
    rp = fast_jit(lambda k: RS.mamba_init(rcfg, k))(jax.random.PRNGKey(3))
    # a non-zero conv bias and D, so both reach the output
    rp = dict(rp, conv_b=(jax.random.normal(jax.random.PRNGKey(4),
                                            rp["conv_b"].shape) * 0.1
                          ).astype(rp["conv_b"].dtype),
              D=rp["D"] * 0.5 + 0.25)
    blk = S.Mamba(pcfg, "cpu", torch.Generator().manual_seed(0))
    for name, val in ref_tree_numpy(rp).items():
        t = getattr(blk, name)
        assert t.shape == val.shape, name
        t.copy_(torch.from_numpy(val))
        assert t.dtype == (torch.float32 if name in ("dt_bias", "A_log", "D")
                           else blk.in_proj.dtype), name
    return dtype, rcfg, rp, pcfg, blk


def test_segsum_and_causal_conv():
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 3, 12), scale=0.3)
    _close(S._segsum(xt), fast_jit(RS._segsum)(xj))
    assert bool(torch.isinf(S._segsum(xt)[..., 0, 1]).all())
    for dtype in ("float32", "bfloat16"):
        xj, xt = _pair(rng, (2, 9, 20), dtype)
        wj, wt = _pair(rng, (4, 20), dtype, 0.3)
        bj, bt = _pair(rng, (20,), dtype, 0.1)
        got = S._causal_conv(xt, wt, bt)
        assert got.dtype == xt.dtype
        _close(got, fast_jit(RS._causal_conv)(xj, wj, bj), dtype)


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked(nc, with_init):
    rng = np.random.default_rng(nc + 2 * with_init)
    b, chunk, h, p, g, n = 2, 8, 4, 6, 2, 5
    s = nc * chunk
    xj, xt = _pair(rng, (b, s, h, p))
    dtj = jnp.asarray(np.abs(rng.standard_normal((b, s, h))) * 0.2,
                      jnp.float32)
    dtt = torch.from_numpy(np.array(dtj))
    A = -np.arange(1, h + 1, dtype=np.float32)
    Bj, Bt = _pair(rng, (b, s, g, n))
    Cj, Ct = _pair(rng, (b, s, g, n))
    s0j = s0t = None
    if with_init:
        s0j, s0t = _pair(rng, (b, h, p, n))
    yr, fr = fast_jit(lambda *a: RS._ssd_chunked(*a[:5], chunk, *a[5:]))(
        xj, dtj, jnp.asarray(A), Bj, Cj, *([] if s0j is None else [s0j]))
    yp, fp = S._ssd_chunked(xt, dtt, torch.from_numpy(A), Bt, Ct, chunk, s0t)
    assert yp.dtype == fp.dtype == torch.float32
    _close(yp, yr)
    _close(fp, fr)


@pytest.mark.parametrize("S_len", [21, 64])
def test_mamba_apply_and_decode(block, S_len):
    """mamba_apply(return_state=True) at a chunk multiple (64: two chunks of
    the reduced config's 32) and not (21), then three decode steps from its
    state."""
    dtype, rcfg, rp, pcfg, blk = block
    rng = np.random.default_rng(S_len)
    xj, xt = _pair(rng, (2, S_len, rcfg.d_model), dtype)
    yr, str_ = _ref_apply(rcfg)(rp, xj)
    yp, stp = S.mamba_apply(pcfg, blk, xt, return_state=True)
    assert yp.dtype == xt.dtype and stp.ssm.dtype == torch.float32
    _close(yp, yr, dtype)
    _close(stp.ssm, str_.ssm, dtype)
    # the conv state is the last raw rows of the in-projection (bitwise the
    # port's own projection; the projections of the two frameworks differ
    # in their last bits)
    _close(stp.conv, str_.conv, dtype)
    zx = S.ein("bsd,dk->bsk", xt, blk.in_proj).to(xt.dtype)
    di = pcfg.ssm.d_inner(pcfg.d_model)
    assert torch.equal(stp.conv, zx[:, -(pcfg.ssm.conv_width - 1):,
                                    di:stp.conv.shape[-1] + di])
    _close(S.mamba_apply(pcfg, blk, xt), yr, dtype)
    for t in range(3):
        dj, dt = _pair(rng, (2, 1, rcfg.d_model), dtype)
        yr, str_ = _ref_decode(rcfg)(rp, dj, str_)
        yp, stp = S.mamba_decode(pcfg, blk, dt, stp)
        _close(yp, yr, dtype)
        _close(stp.ssm, str_.ssm, dtype)
        _close(stp.conv, str_.conv, dtype)


def test_mamba_apply_continues_from_a_state(block):
    """``init_state``: the second half of a sequence from the first half's
    state == the reference's (halves of 21 rows, not a chunk multiple: the
    first half's compile is test_mamba_apply_and_decode's)."""
    dtype, rcfg, rp, pcfg, blk = block
    rng = np.random.default_rng(9)
    xj, xt = _pair(rng, (2, 42, rcfg.d_model), dtype)
    _, s1r = _ref_apply(rcfg)(rp, xj[:, :21])
    _, s1p = S.mamba_apply(pcfg, blk, xt[:, :21], return_state=True)
    yr, _ = _ref_apply(rcfg)(rp, xj[:, 21:], s1r)
    yp = S.mamba_apply(pcfg, blk, xt[:, 21:], init_state=s1p)
    _close(yp, yr, dtype)


def test_init_ssm_state():
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _cfgs(dtype)
        want = RS.init_ssm_state(rcfg, 3)
        got = S.init_ssm_state(pcfg, 3, "cpu")
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and not bool(g.any())
            assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_c11_short_prompt_decode(arch):
    """ROADMAP C11: after a prompt of 1 or 2 tokens (conv_width - 1 is 3)
    the reference's decode raises (asserted, so this test notes when the
    reference changes; it raises while tracing, so shapes are enough); the
    port's decode logits equal the reference's forward over the whole
    sequence."""
    rcfg, pcfg = _cfgs(arch=arch)
    model = MD.init(pcfg, "cpu", seed=5)
    params = ref_params(model)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (2, 4)
                                             ).astype(np.int32)
    full, _, _ = fast_jit(lambda p, t: RMD.forward(rcfg, p, {"tokens": t}))(
        params, jnp.asarray(toks))
    for n in (1, 2):
        _, rc = jax.eval_shape(lambda p, t: RMD.prefill(
            rcfg, p, {"tokens": t}, s_max=8), params, jnp.asarray(toks[:, :n]))
        with pytest.raises(ValueError, match="does not match"):
            jax.eval_shape(lambda p, c, t: RMD.decode_step(rcfg, p, c, t),
                           params, rc, jnp.asarray(toks[:, n]))
        _, pc = MD.prefill(pcfg, model, {"tokens": torch.from_numpy(
            toks[:, :n])}, s_max=8)
        conv = pc["ssm"].conv
        assert conv.shape[2] == pcfg.ssm.conv_width - 1
        assert not bool(conv[:, :, :pcfg.ssm.conv_width - 1 - n].any())
        for t in range(n, 4):
            lg, pc = MD.decode_step(pcfg, model, pc,
                                    torch.from_numpy(toks[:, t]))
            np.testing.assert_allclose(lg.numpy(), np.asarray(full[:, t]),
                                       rtol=1e-4, atol=1e-4)
