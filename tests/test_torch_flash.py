"""Full-sequence attention of the port: the plain ``flash_attention`` (what
its CPU path runs and what its CUDA kernel is held against on the card)
against the reference's oracle (``repro.kernels.ref.flash_attention``) and,
where the two agree, the reference's Pallas kernel in interpret mode, over
the case list of ``tests/test_kernels.py``; ``ops.flash_attention`` on a CPU
tensor; the model's full-sequence attention (``attn_apply``,
``attn_prefill``, the prefix-sharing admission's ``_attend`` with query
offsets) against the reference's. Then the dense decode through the paged
kernel's plain version (ROADMAP C3): bitwise the previous ``_sdpa``
arithmetic on the CPU.

Tolerances: the reference's own kernel-vs-oracle ones (fp32 2e-5; bf16 2e-2:
the two frameworks round the bf16 logits, softmax and products in their own
order), unless a test says otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import flash_attention as K_fa
from repro.kernels import ref as ref_ref
from repro.models import layers as RL
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

from _torch_port import no_activation_mesh  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _qkv(shapes, dtype="float32", seed=0, zero_q=False):
    """(jax, torch) pairs of q, k, v drawn with numpy; the torch copies are
    the jax arrays' exact values."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape) * 0.5
        if zero_q and i == 0:
            a = np.zeros(shape)
        j = jnp.asarray(a, jd)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(td)))
    return out


@pytest.mark.parametrize("B,H,S,hd,bq,bk", [
    (1, 1, 32, 8, 8, 8),
    (2, 3, 64, 16, 16, 16),
    (1, 2, 128, 32, 64, 32),
    (2, 1, 96, 16, 32, 16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_vs_reference(B, H, S, hd, bq, bk, causal,
                                            dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(B, H, S, hd)] * 3, dtype)
    got = ref.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, H, S, hd)
    want = ref_ref.flash_attention(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    kernel = K_fa.flash_attention(qj, kj, vj, causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(dtype))


def test_plain_flash_cross_attention_rect():
    """Sq != Sk, non-causal (cross attention)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(1, 2, 32, 16), (1, 2, 64, 16),
                                         (1, 2, 64, 16)], seed=1)
    got = ref.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(
        _np(got), _np(ref_ref.flash_attention(qj, kj, vj, causal=False)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        _np(got), _np(K_fa.flash_attention(qj, kj, vj, causal=False,
                                           block_q=16, block_k=16,
                                           interpret=True)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [16, 48, 80])
@pytest.mark.parametrize("hd", [8, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_sweep(S, hd, causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(1, 2, S, hd)] * 3, seed=S + hd)
    np.testing.assert_allclose(
        _np(ref.flash_attention(qt, kt, vt, causal=causal)),
        _np(ref_ref.flash_attention(qj, kj, vj, causal=causal)),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_hd80_vs_reference(causal, dtype):
    """zamba2's head width, 80 (not a multiple of 16): the plain version
    against the reference's oracle, a prefill and a cross-attention shape
    (Sq != Sk, the whisper decoder's)."""
    for sq, sk in ((40, 40), (8, 72)):
        if causal and sq != sk:
            continue
        (qj, qt), (kj, kt), (vj, vt) = _qkv([(2, 3, sq, 80), (2, 3, sk, 80),
                                             (2, 3, sk, 80)], dtype, seed=sk)
        got = ref.flash_attention(qt, kt, vt, causal=causal)
        assert got.shape == (2, 3, sq, 80)
        want = ref_ref.flash_attention(qj, kj, vj, causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_plain_flash_softmax_invariance():
    """q = 0: every visible key weighs alike, so a causal row is the mean of
    the value rows up to it."""
    _, (_, kt), (vj, vt) = _qkv([(1, 1, 32, 8)] * 3, seed=2, zero_q=True)
    qt = torch.zeros((1, 1, 32, 8))
    got = ref.flash_attention(qt, kt, vt, causal=True)
    expect = np.cumsum(_np(vj)[0, 0], axis=0) / np.arange(1, 33)[:, None]
    np.testing.assert_allclose(got[0, 0].numpy(), expect, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("Sq,Sk", [(24, 64), (1, 40), (64, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_causal_rectangular_follows_the_oracle(Sq, Sk, dtype):
    """Causal with Sq != Sk: bottom-right aligned as the oracle (query row i
    sees the keys up to i + Sk - Sq), not top-left as the TPU kernel masks
    (ROADMAP R4). With Sq > Sk the first rows see no key and take the
    oracle's fully masked softmax (every key alike)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(2, 2, Sq, 16), (2, 2, Sk, 16),
                                         (2, 2, Sk, 16)], dtype, seed=Sq)
    got = ref.flash_attention(qt, kt, vt, causal=True)
    want = ref_ref.flash_attention(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    if Sq > Sk:                           # rows with no visible key
        mean = _np(vj).mean(axis=2)
        np.testing.assert_allclose(_np(got)[:, :, 0], mean, **_tol(dtype))


def test_ops_flash_attention_on_cpu_takes_the_plain_version():
    (_, qt), (_, kt), (_, vt) = _qkv([(2, 2, 24, 16)] * 3, seed=3)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert torch.equal(got, ref.flash_attention(qt, kt, vt, causal=True))
    assert ops.launch_counts()["flash_attention"] == before
    assert "flash_attention" in ops.KERNELS


def test_flash_dtype_route_chooses_the_entry_point_without_launching():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    assert FA.route(torch.bfloat16) == "tensor_core"
    assert FA.route(torch.float32) == "cuda_core"
    assert FA.ENTRY == {"tensor_core": "flash_attention_tc_launch",
                        "cuda_core": "flash_attention_launch"}
    with pytest.raises(TypeError, match="float16"):
        FA.route(torch.float16)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for symbol in FA.ENTRY.values():
        assert f'extern "C" int {symbol}(' in src
    assert FA.FLASH.ROUTE_LAUNCHES == {"tensor_core": 0, "cuda_core": 0}


@pytest.mark.parametrize("hd", [4, 12, 20, 272])
def test_flash_head_widths_the_tensor_core_kernel_does_not_take(hd):
    """bf16 takes hd a multiple of 8 from 8 to 256, anything else refused
    before launch; fp32 (the CUDA-core kernel) any hd up to 256."""
    from repro_torch.kernels import flash_attention as FA
    q = torch.zeros((1, 4, 5, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 7, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd"):
        FA._check(q, k, k, None, None)
    if hd <= 256:
        assert FA._check(q.float(), k.float(), k.float(), None,
                         None) == "cuda_core"
    else:
        with pytest.raises(ValueError, match="hd <= 256"):
            FA._check(q.float(), k.float(), k.float(), None, None)
    assert FA.FLASH.LAUNCHES == 0


@pytest.mark.parametrize("hd", [8, 16, 24, 48, 80, 96, 128, 256])
def test_flash_tensor_core_layouts(hd):
    """Every multiple of 8 up to 256 is taken (zamba2's 80 and
    phi-3-vision's 96 among them), in the model's strided layout too; a
    stride or a base the 16-byte copies cannot follow is refused."""
    from repro_torch.kernels import flash_attention as FA
    bf = torch.bfloat16
    qm = torch.zeros((2, 9, 4, hd), dtype=bf)             # [B, S, H, hd]
    km = torch.zeros((2, 9, 2, hd), dtype=bf)
    assert FA._check(qm.transpose(1, 2), km.transpose(1, 2),
                     km.transpose(1, 2), torch.zeros(2, dtype=torch.int32),
                     torch.empty((2, 9, 4, hd), dtype=bf).transpose(1, 2)
                     ) == "tensor_core"
    wide = torch.zeros((1, 4, 5, hd + 4), dtype=bf)[..., :hd]  # stride hd+4
    k = torch.zeros((1, 2, 5, hd), dtype=bf)
    with pytest.raises(ValueError, match="strides multiples of 8"):
        FA._check(wide, k, k, None, None)
    flat = torch.zeros(4 * 5 * hd + 8, dtype=bf)
    shifted = flat[1:1 + 4 * 5 * hd].view(1, 4, 5, hd)   # 2-byte offset
    with pytest.raises(ValueError, match="16-byte"):
        FA._check(shifted, k, k, None, None)


# ---------------------------------------------------------------------------
# the model's full-sequence attention
# ---------------------------------------------------------------------------

def _cfgs():
    return (ref_configs.get(ARCH).reduced().replace(dtype="float32"),
            configs.get(ARCH).reduced().replace(dtype="float32"))


def _attn(rng, rcfg, pcfg):
    d, hd, nq, nkv = rcfg.d_model, rcfg.hd, rcfg.n_heads, rcfg.n_kv_heads
    w = {"wq": rng.standard_normal((d, nq * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, nkv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, nkv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((nq * hd, d)) / np.sqrt(nq * hd)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    mod = L.Attention(pcfg, "cpu", torch.Generator())
    for k, v in w.items():
        getattr(mod, k).copy_(torch.from_numpy(v))
    return {k: jnp.asarray(v) for k, v in w.items()}, mod


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("positions", [None, "offset"])
def test_attn_apply_vs_reference(causal, positions):
    rcfg, pcfg = _cfgs()
    rng = np.random.default_rng(5)
    rp, pm = _attn(rng, rcfg, pcfg)
    x = rng.standard_normal((2, 11, rcfg.d_model)).astype(np.float32)
    pos = None if positions is None else (np.arange(11)[None, :] + 7)
    want = RL.attn_apply(rcfg, rp, jnp.asarray(x),
                         inv_freq=RL.rope_freqs(rcfg.hd, rcfg.rope_theta),
                         positions=None if pos is None else jnp.asarray(pos),
                         causal=causal)
    got = L.attn_apply(pcfg, pm, torch.from_numpy(x),
                       inv_freq=L.rope_freqs(pcfg.hd, pcfg.rope_theta),
                       positions=None if pos is None else torch.from_numpy(pos),
                       causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # cross-attention (the whisper decoder's): k and v from an encoder
    # output of another length, no RoPE, no mask
    enc = rng.standard_normal((2, 19, rcfg.d_model)).astype(np.float32)
    want = RL.attn_apply(rcfg, rp, jnp.asarray(x), inv_freq=None,
                         kv=jnp.asarray(enc))
    got = L.attn_apply(pcfg, pm, torch.from_numpy(x), inv_freq=None,
                       kv=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_attend_with_query_offsets_is_the_verify_mask():
    """The prefix-sharing admission's attention (``_attend`` with
    ``qoff = pos``) on the CPU: exactly ``_sdpa`` on the verify mask (query i
    of row b sees the rows up to ``pos[b] + i``), and with ``qoff`` None the
    causal prefill mask."""
    rng = np.random.default_rng(6)
    B, T, Sk, nq, nkv, hd = 2, 5, 16, 4, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, T, nq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Sk, nkv, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Sk, nkv, hd)).astype(
        np.float32))
    pos = torch.tensor([3, 9], dtype=torch.int32)
    positions = pos[:, None] + torch.arange(T)[None, :]
    valid = (torch.arange(Sk)[None, None, :]
             <= positions[:, :, None])[:, None, :, :]
    assert torch.equal(L._attend(q, k, v, 2, qoff=pos),
                       L._sdpa(q, k, v, valid, 2))
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool))[None, None]
    assert torch.equal(L._attend(q, k[:, :T], v[:, :T], 2),
                       L._sdpa(q, k[:, :T], v[:, :T], tril, 2))


# ---------------------------------------------------------------------------
# C3: dense decode through the paged kernel's contiguous table
# ---------------------------------------------------------------------------

def _old_decode(cfg, p, x, cache_k, cache_v, pos, s_max, inv_freq):
    """The dense decode attention as it was before it went through the paged
    kernel: ``_sdpa`` over the whole cache on the mask ``arange <= pos``
    (rows at or past ``s_max`` masked), the out-of-range write dropped."""
    B = x.shape[0]
    rows = cache_k.shape[1]
    q, k, v = L._qkv(cfg, p, x)
    q = L.apply_rope(q, pos[:, None], inv_freq)
    k = L.apply_rope(k, pos[:, None], inv_freq)
    b = torch.arange(B)
    ok = (pos < s_max)[:, None, None]
    row = pos.clamp(max=s_max - 1).to(torch.long)
    cache_k[b, row] = torch.where(ok, k[:, 0], cache_k[b, row])
    cache_v[b, row] = torch.where(ok, v[:, 0], cache_v[b, row])
    valid = ((torch.arange(rows)[None, :] <= pos[:, None])
             & (torch.arange(rows)[None, :] < s_max))[:, None, None, :]
    out = L._sdpa(q, cache_k, cache_v, valid,
                  cfg.n_heads // cfg.n_kv_heads).reshape(B, 1, -1)
    return L.ein("bsh,hd->bsd", out, p.wo).to(x.dtype)


@pytest.mark.parametrize("s_max,bs", [(16, 4), (16, 16), (12, 8), (13, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_through_the_paged_table_is_the_old_arithmetic(s_max, bs,
                                                                     dtype):
    """``attn_decode_slots`` with the cache viewed as a pool of ``bs``-row
    blocks (rows rounded up to a multiple of ``bs``) equals the previous
    ``_sdpa`` arithmetic BITWISE on the CPU, with a frozen slot at ``pos ==
    s_max`` (its write dropped, all ``s_max`` rows visible) and the rows
    past ``s_max`` never visible (filled with large values here: a plain
    softmax's zero weight times NaN would still be NaN)."""
    _, pcfg = _cfgs()
    td = DTYPES[dtype][1]
    pcfg = pcfg.replace(dtype=dtype)
    rng = np.random.default_rng(7)
    _, pm = _attn(rng, *_cfgs())
    pm = pm.to(td)
    rows = -(-s_max // bs) * bs
    B = 4
    x = torch.from_numpy(rng.standard_normal((B, 1, pcfg.d_model)).astype(
        np.float32)).to(td)
    ck = torch.from_numpy(rng.standard_normal(
        (B, rows, pcfg.n_kv_heads, pcfg.hd)).astype(np.float32)).to(td)
    cv = torch.from_numpy(rng.standard_normal(ck.shape).astype(
        np.float32)).to(td)
    ck[:, s_max:] = 1e4
    cv[:, s_max:] = 1e4
    pos = torch.tensor([2, s_max, 0, s_max - 1], dtype=torch.int32)
    inv = L.rope_freqs(pcfg.hd, pcfg.rope_theta)
    want_k, want_v = ck.clone(), cv.clone()
    want = _old_decode(pcfg, pm, x, want_k, want_v, pos, s_max, inv)
    got, gk, gv = L.attn_decode_slots(
        pcfg, pm, x, ck, cv, pos, inv_freq=inv,
        view=L.decode_view(pos, rows, s_max, bs))
    assert gk is ck and gv is cv                          # in place
    assert torch.equal(got, want)
    assert torch.equal(ck, want_k) and torch.equal(cv, want_v)
    assert bool(torch.isfinite(got).all())
