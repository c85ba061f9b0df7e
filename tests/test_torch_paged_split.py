"""The split plan of the port's ``paged_attention`` / ``paged_attention_q``
CUDA kernels (``csrc/paged_attention.cuh``), on the CPU.

* The plan's constants in ``kernels/paged_attention.py`` are the header's
  ``constexpr``s; a split is a whole number of table entries and the splits
  cover the table; the wrapper's split count, and so its workspace and grid,
  is a function of (mb, bs) alone, whatever B, the pool size and ``lens``
  hold, and the wrapper never reads ``lens`` on the host (driven against a
  stubbed launcher: nothing runs).
* A PyTorch emulation of the two passes in fp32 (this file's ``_emulate``:
  per split an online softmax over 16-row stages in ascending order, then the
  partials combined in ascending split order) against the reference's jnp
  oracle and its Pallas kernels in interpret mode, on the same numpy inputs,
  at lens on every split boundary, lens 1 and the whole table, GQA shapes
  and int8 pools (lens 0: zeros, as the port's kernels give; the
  reference's -1e30 mask averages whatever its clipped block holds there);
  ``rtol = atol = 2e-5`` as ``_close`` of
  ``test_torch_paged_attention.py`` (the order of the fp32 sums differs). A
  slot's emulated output is bitwise the same alone, among 8 slots and with
  its table padded by sentinels to twice its length.

The kernels themselves are held to their plain version, and to these
bitwise equalities, on the card by ``chip_smoke.py``.
"""
import math
import re
from contextlib import nullcontext

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as RQ
from repro.kernels import paged_attention as K_pa
from repro.kernels import ref as ref_ref
from repro_torch.kernels import _build, _common, paged_attention as PA

from _torch_port import no_activation_mesh  # noqa: F401
from test_torch_paged_attention import _close, _inputs


def _constexpr(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_plan_constants_are_the_kernels():
    src = (_build.CSRC / "paged_attention.cuh").read_text()
    assert (PA.SPLIT_ROWS, PA.CHUNK_ROWS, PA.STAGES) == tuple(
        _constexpr(src, n) for n in ("kSplitRows", "kChunkRows", "kStages"))
    # a split is at least one ring stage, the ring has two stages or more
    assert PA.SPLIT_ROWS % PA.CHUNK_ROWS == 0 and PA.STAGES >= 2
    for name in ("paged_attention.cu", "paged_attention_q.cu"):
        assert '#include "paged_attention.cuh"' in (_build.CSRC / name
                                                    ).read_text()


@pytest.mark.parametrize("mb", [1, 7, 32])
@pytest.mark.parametrize("bs", [1, 3, 4, 8, 16, 24, 64, 128])
def test_splits_are_whole_entries_and_cover_the_table(bs, mb):
    R, S = PA.split_rows(bs), PA.n_splits(mb, bs)
    assert R % bs == 0 and R >= bs
    assert R == max(bs, PA.SPLIT_ROWS // bs * bs)
    assert (S - 1) * R < mb * bs <= S * R


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes its
    launch path (against a stubbed launcher: nothing runs)."""

    @property
    def is_cuda(self):
        return True


class _NoHostRead(_OnCard):
    """``lens`` on the card: a host read of it fails the test."""

    def _refuse(self, *a, **k):
        raise AssertionError("the wrapper read lens on the host")

    tolist = item = numpy = cpu = __int__ = __index__ = __bool__ = _refuse


@pytest.fixture
def stub_launch(monkeypatch):
    """``_common.launcher`` returns a C function that records its symbol and
    arguments and returns 0 (launched); the kernels' launch counts are put
    back afterwards (nothing ran)."""
    calls = []
    for kern in (PA.PAGED, PA.PAGED_Q):
        monkeypatch.setattr(kern, "LAUNCHES", kern.LAUNCHES)
        monkeypatch.setattr(kern, "ROUTE_LAUNCHES", dict(kern.ROUTE_LAUNCHES))

    def launcher(symbol, n_ptr, n_int, tail=(), source=None):
        def fn(*args):
            assert len(args) == n_ptr + n_int + len(tail) + 1
            calls.append(dict(symbol=symbol, n_ptr=n_ptr, args=args))
            return 0
        return fn
    monkeypatch.setattr(_common, "launcher", launcher)
    monkeypatch.setattr(_common, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    return calls


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_q"])
def test_wrapper_plan_is_the_table_shape_alone(stub_launch, monkeypatch,
                                               name):
    """Whatever B, the pool size and ``lens`` hold, the workspace holds
    ``n_splits(mb, bs)`` partials of hd + 2 numbers per (slot, query head);
    the wrapper never reads ``lens`` on the host and counts one launch per
    call on its kernel."""
    seen = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.float32 and "device" in kw:
            seen.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", empty)
    kern = PA.PAGED_Q if name == "paged_attention_q" else PA.PAGED
    nq, nkv, hd, bs, mb = 8, 2, 16, 4, 5
    for B, nb, lens in ((1, 3, [0]), (8, 50, [1, 2, 3, 4, 20, 19, 17, 0]),
                        (3, 7, [20, 20, 20])):
        before = kern.LAUNCHES
        q = torch.zeros((B, nq, hd)).as_subclass(_OnCard)
        pool = torch.zeros((nb, bs, nkv, hd),
                           dtype=torch.int8 if kern is PA.PAGED_Q
                           else torch.float32)
        tab = torch.full((B, mb), nb, dtype=torch.int32)
        ln = torch.tensor(lens, dtype=torch.int32).as_subclass(_NoHostRead)
        if kern is PA.PAGED_Q:
            sc = torch.ones((nb, bs, nkv))
            PA.paged_attention_q(q, pool, pool, sc, sc, tab, ln)
        else:
            PA.paged_attention(q, pool, pool, tab, ln)
        call = stub_launch[-1]
        assert call["symbol"] == name + "_launch"
        assert seen[-1] == B * nq * PA.n_splits(mb, bs) * (hd + 2)
        ints = list(call["args"][call["n_ptr"]:call["n_ptr"] + 7])
        assert ints == [B, nb, bs, nkv, hd, mb, nq // nkv]
        assert kern.LAUNCHES == before + 1


# ---------------------------------------------------------------------------
# the two passes, emulated in fp32
# ---------------------------------------------------------------------------

def _emulate(q, kp, vp, tab, lens, ks=None, vs=None):
    """fp32 emulation of the split pass and the combine pass, slot by slot
    (so a slot's arithmetic cannot see the others): split s of slot b holds
    the rows [s R, min((s + 1) R, len)), len = min(lens[b], mb bs), and runs
    the online softmax over stages of CHUNK_ROWS rows in ascending order
    (int8 pools: the row's K scale times q . k_int, its V scale times the
    weight); the partials combine in ascending split order and divide
    once."""
    B, nq, hd = q.shape
    nb, bs, nkv, _ = kp.shape
    mb = tab.shape[1]
    R, S, C = PA.split_rows(bs), PA.n_splits(mb, bs), PA.CHUNK_ROWS
    n_rep = nq // nkv
    q = q.float()
    tab = tab.long()
    out = torch.zeros((B, nq, hd))
    for b in range(B):
        n = min(max(int(lens[b]), 0), mb * bs)
        parts = []
        for s in range(S):
            r0, r1 = s * R, min(s * R + R, n)
            if r0 >= r1:
                continue
            m = torch.full((nq,), -math.inf)
            l = torch.zeros(nq)
            acc = torch.zeros((nq, hd))
            for c0 in range(r0, r1, C):
                rows = torch.arange(c0, min(c0 + C, r1))
                blk = tab[b, rows // bs].clamp(0, nb - 1)
                off = rows % bs
                k = kp[blk, off].float().repeat_interleave(n_rep, 1)
                v = vp[blk, off].float().repeat_interleave(n_rep, 1)
                dot = (k * q[b][None]).sum(-1)                 # [rows, nq]
                if ks is not None:
                    dot = dot * ks[blk, off].repeat_interleave(n_rep, 1)
                sv = dot / math.sqrt(hd)
                m_new = torch.maximum(m, sv.max(0).values)
                p = torch.exp(sv - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(0)
                w = p if vs is None else p * vs[blk, off].repeat_interleave(
                    n_rep, 1)
                acc = acc * alpha[:, None] + (w[:, :, None] * v).sum(0)
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue                                        # lens 0: zeros
        M = torch.stack([p[0] for p in parts]).max(0).values
        L = torch.zeros(nq)
        O = torch.zeros((nq, hd))
        for m, l, acc in parts:
            w = torch.exp(m - M)
            L = L + l * w
            O = O + acc * w[:, None]
        out[b] = O / L[:, None]
    return out


def _both(q, kp, vp, tab, lens):
    """The reference's oracle and its Pallas kernel (interpret mode)."""
    tj, lj = jnp.asarray(tab), jnp.asarray(lens)
    return (ref_ref.paged_attention(q, kp, vp, tj, lj),
            K_pa.paged_attention(q, kp, vp, tj, lj, interpret=True))


def _both_q(q, kq, vq, ks, vs, tab, lens):
    tj, lj = jnp.asarray(tab), jnp.asarray(lens)
    return (ref_ref.paged_attention_q(q, kq, vq, ks, vs, tj, lj),
            K_pa.paged_attention_q(q, kq, vq, ks, vs, tj, lj, interpret=True))


def _boundary_lens(mb, bs):
    """Every split boundary k R - 1, k R, k R + 1 inside the table, lens 1,
    the whole table and 0."""
    R = PA.split_rows(bs)
    out = {1, mb * bs, 0}
    for k in range(1, mb * bs // R + 1):
        out |= {x for x in (k * R - 1, k * R, k * R + 1) if 0 < x <= mb * bs}
    return np.asarray(sorted(out), np.int32)


def _with_lens(B, nq, nkv, hd, bs, mb, lens, seed):
    """``_inputs`` with the given lens: each slot owns ceil(lens / bs)
    distinct blocks of the pool, the rest of its row is the sentinel."""
    nb = B * mb + 1
    q, kp, vp, _, _ = _inputs(B, nq, nkv, hd, nb, bs, mb, seed=seed)
    perm = np.random.default_rng(seed).permutation(nb)
    tab = np.full((B, mb), nb, np.int32)
    used = 0
    for b in range(B):
        need = -(-int(lens[b]) // bs)
        tab[b, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, tab


#: (nq, nkv, hd, bs, mb)
SPLIT_SHAPES = {"mha-bs4": (4, 4, 16, 4, 20), "gqa4-bs16": (8, 2, 16, 16, 6),
                "gqa8-hd32-bs8": (8, 1, 32, 8, 9),
                "serve-like-bs16": (32, 4, 128, 16, 5)}


@pytest.mark.parametrize("shape", list(SPLIT_SHAPES))
def test_split_emulation_vs_reference_at_every_boundary(shape):
    nq, nkv, hd, bs, mb = SPLIT_SHAPES[shape]
    lens = _boundary_lens(mb, bs)
    q, kp, vp, tab = _with_lens(len(lens), nq, nkv, hd, bs, mb, lens,
                                seed=mb * 7 + bs)
    got = _emulate(q[1], kp[1], vp[1], torch.from_numpy(tab),
                   torch.from_numpy(lens))
    assert bool(torch.isfinite(got).all())
    assert bool((got[lens == 0] == 0).all())
    for want in _both(q[0], kp[0], vp[0], tab, lens):
        _close(got[lens > 0], np.asarray(want)[lens > 0], "float32")


@pytest.mark.parametrize("shape", ["gqa4-bs16", "serve-like-bs16"])
def test_split_emulation_int8_vs_reference(shape):
    nq, nkv, hd, bs, mb = SPLIT_SHAPES[shape]
    lens = _boundary_lens(mb, bs)
    q, kp, vp, tab = _with_lens(len(lens), nq, nkv, hd, bs, mb, lens, seed=5)
    kq, ks = RQ.quantize_kv(kp[0])
    vq, vs = RQ.quantize_kv(vp[0])
    kq_t, vq_t, ks_t, vs_t = [torch.from_numpy(np.array(a))
                              for a in (kq, vq, ks, vs)]
    got = _emulate(q[1], kq_t, vq_t, torch.from_numpy(tab),
                   torch.from_numpy(lens), ks_t, vs_t)
    assert bool((got[lens == 0] == 0).all())
    for want in _both_q(q[0], kq, vq, ks, vs, tab, lens):
        _close(got[lens > 0], np.asarray(want)[lens > 0], "float32")


@pytest.mark.parametrize("seed", range(4))
def test_split_emulation_random_lens_vs_reference(seed):
    rng = np.random.default_rng(seed)
    B, nkv, bs = int(rng.choice([2, 5])), int(rng.choice([1, 2])), \
        int(rng.choice([4, 8, 16]))
    nq, hd, mb = nkv * int(rng.choice([1, 4])), 16, int(rng.choice([3, 9]))
    q, kp, vp, tab, lens = _inputs(B, nq, nkv, hd, B * mb + 1, bs, mb,
                                   seed=seed)
    got = _emulate(q[1], kp[1], vp[1], torch.from_numpy(tab),
                   torch.from_numpy(lens))
    for want in _both(q[0], kp[0], vp[0], tab, lens):
        _close(got, want, "float32")


@pytest.mark.parametrize("int8", [False, True])
def test_split_emulation_slot_alone_among_8_and_padded_is_bitwise(int8):
    """The plan reads (mb, bs) only: a slot's splits, stages and combine are
    the same alone, among 8 slots and with its table padded by sentinels to
    2 mb (more splits, all empty)."""
    nq, nkv, hd, bs, mb = 8, 2, 16, 4, 12
    lens = np.asarray([47, 1, 48, 33, 32, 31, 0, 17], np.int32)
    q, kp, vp, tab = _with_lens(8, nq, nkv, hd, bs, mb, lens, seed=13)
    kp, vp = kp[1], vp[1]
    scales = ()
    if int8:
        kq, ks = RQ.quantize_kv(jnp.asarray(kp.numpy()))
        vq, vs = RQ.quantize_kv(jnp.asarray(vp.numpy()))
        kp, vp, *scales = [torch.from_numpy(np.array(a))
                           for a in (kq, vq, ks, vs)]
    tab_t, lens_t = torch.from_numpy(tab), torch.from_numpy(lens)
    nb = kp.shape[0]
    padded = torch.cat([tab_t, torch.full_like(tab_t, nb)], 1)
    assert PA.n_splits(2 * mb, bs) > PA.n_splits(mb, bs)
    group = _emulate(q[1], kp, vp, tab_t, lens_t, *scales)
    assert torch.equal(_emulate(q[1], kp, vp, padded, lens_t, *scales), group)
    for b in range(8):
        alone = _emulate(q[1][b:b + 1], kp, vp, tab_t[b:b + 1],
                         lens_t[b:b + 1], *scales)
        assert torch.equal(alone[0], group[b])
