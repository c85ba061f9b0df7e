"""The port's plain ``paged_attention`` / ``paged_attention_q`` (what its
CPU path runs and what its CUDA kernels are held against on the card) versus
the reference: the jnp oracles in ``repro.kernels.ref`` and the Pallas kernel
bodies in interpret mode, on the same numpy pools and tables, over the case
list of ``tests/test_kernels.py``: GQA shapes, int8 pools, sentinel-block
immunity, ``lens == 0`` finiteness, a contiguous table equal to dense SDPA.

Tolerances. fp32: the order of the fp32 sums differs, ``rtol = atol =
2e-5`` as the reference's own kernel-vs-oracle tests use. bf16: the oracle
rounds the softmax to bf16 before the value product while the kernels keep it
fp32, so two bf16 ulps of the output scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro.kernels import paged_attention as K_pa
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops, paged_attention as PA, ref

from _torch_port import no_activation_mesh  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * scale / 128)


def _inputs(B, nq, nkv, hd, nb, bs, mb, seed=0, dtype="float32"):
    """Random pool + a valid per-slot table (each slot owns ceil(lens/bs)
    distinct blocks, the rest of its row is the sentinel ``nb``), as
    (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]

    def both(a):
        j = jnp.asarray(a, jd)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)

    q = both(rng.standard_normal((B, nq, hd)) * 0.5)
    kp = both(rng.standard_normal((nb, bs, nkv, hd)) * 0.5)
    vp = both(rng.standard_normal((nb, bs, nkv, hd)) * 0.5)
    lens = rng.integers(1, mb * bs + 1, size=B).astype(np.int32)
    tab = np.full((B, mb), nb, np.int32)
    perm = rng.permutation(nb)
    used = 0
    for b in range(B):
        need = -(-int(lens[b]) // bs)
        tab[b, :need] = perm[used:used + need]
        used += need
    assert used <= nb
    return q, kp, vp, tab, lens


SHAPES = {"mha": (2, 4, 4, 16, 4, 3), "gqa4": (3, 8, 2, 16, 8, 2),
          "hd32": (1, 4, 4, 32, 4, 4), "serve-like": (4, 8, 1, 128, 16, 4)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_paged_attention_vs_reference(shape, dtype):
    B, nq, nkv, hd, bs, mb = SHAPES[shape]
    nb = B * mb + 2
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, nb, bs, mb,
                                   seed=B * 7 + mb, dtype=dtype)
    got = ops.paged_attention(q[1], kp[1], vp[1], torch.from_numpy(tab),
                              torch.from_numpy(lens))
    assert got.shape == (B, nq, hd) and got.dtype == q[1].dtype
    tj, lj = jnp.asarray(tab), jnp.asarray(lens)
    _close(got, ref_ref.paged_attention(q[0], kp[0], vp[0], tj, lj), dtype)
    _close(got, K_pa.paged_attention(q[0], kp[0], vp[0], tj, lj,
                                     interpret=True), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_attention_q_vs_reference(dtype):
    B, nq, nkv, hd, bs, mb = 3, 8, 2, 16, 4, 3
    nb = B * mb + 1
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, nb, bs, mb, seed=5,
                                   dtype=dtype)
    kq, ks = RQ.quantize_kv(kp[0])
    vq, vs = RQ.quantize_kv(vp[0])
    t = [torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)]
    got = ops.paged_attention_q(q[1], *t, torch.from_numpy(tab),
                                torch.from_numpy(lens))
    tj, lj = jnp.asarray(tab), jnp.asarray(lens)
    _close(got, ref_ref.paged_attention_q(q[0], kq, vq, ks, vs, tj, lj), dtype)
    _close(got, K_pa.paged_attention_q(q[0], kq, vq, ks, vs, tj, lj,
                                       interpret=True), dtype)


def test_sentinel_and_unowned_blocks_contribute_nothing():
    """Blocks a slot does not own (reached through clipped sentinel entries)
    and rows past ``lens`` may hold anything: huge values change no output
    bit. (The CUDA kernel never loads such rows, so even NaN there changes
    nothing; ``chip_smoke.py`` checks that on the card.)"""
    B, nq, nkv, hd, bs, mb = 2, 4, 2, 16, 4, 3
    nb = B * mb + 2
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, nb, bs, mb, seed=11)
    owned = set(tab.reshape(-1).tolist()) - {nb}
    kp2, vp2 = kp[1].clone(), vp[1].clone()
    for blk in range(nb):
        if blk not in owned:
            kp2[blk] = 1e4
            vp2[blk] = 1e4
    for b in range(B):                   # rows past lens in the last block
        last = tab[b, (lens[b] - 1) // bs]
        kp2[last, (lens[b] - 1) % bs + 1:] = 1e4
        vp2[last, (lens[b] - 1) % bs + 1:] = 1e4
    args = (torch.from_numpy(tab), torch.from_numpy(lens))
    assert torch.equal(ops.paged_attention(q[1], kp[1], vp[1], *args),
                       ops.paged_attention(q[1], kp2, vp2, *args))


def test_zero_lens_row_is_finite():
    B, nq, nkv, hd, bs, mb = 2, 4, 2, 16, 4, 2
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, B * mb, bs, mb, seed=3)
    lens = np.asarray([0, lens[1]], np.int32)
    y = ops.paged_attention(q[1], kp[1], vp[1], torch.from_numpy(tab),
                            torch.from_numpy(lens))
    assert torch.isfinite(y).all()
    yr = ref_ref.paged_attention(q[0], kp[0], vp[0], jnp.asarray(tab),
                                 jnp.asarray(lens))
    _close(y[1], yr[1], "float32")


def test_contiguous_table_equals_dense_sdpa():
    """An identity table makes the pool a reshaped dense cache: the paged
    plain version then equals the dense decode attention of the slot
    engine's layers, bitwise (the same ``_sdpa`` arithmetic)."""
    from repro_torch.models.layers import _sdpa
    B, nq, nkv, hd, bs, mb = 2, 4, 2, 16, 4, 3
    nb = B * mb
    q, kp, vp, _, lens = _inputs(B, nq, nkv, hd, nb, bs, mb, seed=9)
    tab = torch.arange(nb, dtype=torch.int32).reshape(B, mb)
    y = ops.paged_attention(q[1], kp[1], vp[1], tab, torch.from_numpy(lens))
    kc = kp[1].reshape(B, mb * bs, nkv, hd)
    vc = vp[1].reshape(B, mb * bs, nkv, hd)
    pos = torch.from_numpy(lens) - 1
    valid = (torch.arange(mb * bs)[None, :] <= pos[:, None])[:, None, None, :]
    dense = _sdpa(q[1][:, None], kc, vc, valid, nq // nkv)[:, 0]
    assert torch.equal(y, dense)
    yr = ref_ref._paged_sdpa(q[0], jnp.asarray(kc.numpy()),
                             jnp.asarray(vc.numpy()), jnp.asarray(lens))
    _close(y, yr, "float32")


@pytest.mark.parametrize("seed", range(6))
def test_random_shapes_vs_reference(seed):
    rng = np.random.default_rng(seed)
    B, nkv, bs = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2])), \
        int(rng.choice([4, 8]))
    nq, hd, mb = nkv * 2, 16, 2
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, B * mb + 1, bs, mb,
                                   seed=seed)
    got = ops.paged_attention(q[1], kp[1], vp[1], torch.from_numpy(tab),
                              torch.from_numpy(lens))
    _close(got, K_pa.paged_attention(q[0], kp[0], vp[0], jnp.asarray(tab),
                                     jnp.asarray(lens), interpret=True),
           "float32")


def test_gather_pool_clips_sentinels():
    pool = torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2)
    got = ref._gather_pool(pool, torch.tensor([[2, 3], [0, 7]]))
    assert got.tolist() == [[4, 5, 4, 5], [0, 1, 4, 5]]


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_q"])
def test_cpu_dispatch_takes_plain_paged_version_and_counts_no_launch(name):
    kern = ops.KERNELS[name]
    before = kern.LAUNCHES
    q, kp, vp, tab, lens = _inputs(1, 2, 1, 16, 2, 4, 2)
    args = (torch.from_numpy(tab), torch.from_numpy(lens))
    if name == "paged_attention":
        ops.paged_attention(q[1], kp[1], vp[1], *args)
    else:
        ops.paged_attention_q(q[1], kp[1].to(torch.int8), vp[1].to(torch.int8),
                              torch.ones(kp[1].shape[:3]),
                              torch.ones(kp[1].shape[:3]), *args)
    assert kern.LAUNCHES == before and kern.plain is getattr(ref, name)


def test_paged_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    q, kp, vp, tab, lens = _inputs(1, 2, 1, 16, 2, 4, 2)
    args = (torch.from_numpy(tab), torch.from_numpy(lens))
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention(q[1], kp[1], vp[1], *args)
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_q(q[1], kp[1], vp[1], kp[1], vp[1], *args)
    with pytest.raises(ValueError, match="does not fit"):
        PA._check("t", q[1][:, :1, :8], kp[1], vp[1], *args, torch.float32)
    with pytest.raises(TypeError, match="kp"):
        PA._check("t", q[1], kp[1].to(torch.int8), vp[1], *args,
                  torch.float32)
