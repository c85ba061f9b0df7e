"""The port's copy of the paged-KV block allocator
(``repro_torch.serving.paging``) against the reference's
(``repro.serving.paging``): every scenario of ``tests/test_paged_allocator.py``
run on the copy, then random operation traces on which the copy's
``state_dict()`` equals the reference allocator's after every operation.
Host code only: no device, no tolerance.
"""
import numpy as np
import pytest

import test_paged_allocator as RT
from repro.serving.paging import PagedAllocator as RefAllocator
from repro_torch.serving.paging import PagedAllocator

SCENARIOS = sorted(n for n in dir(RT) if n.startswith("test_"))


def test_the_scenario_list_is_the_reference_suite():
    assert len(SCENARIOS) >= 14 and "test_random_traces_hold_invariants" \
        in SCENARIOS


@pytest.mark.parametrize("name", SCENARIOS)
def test_reference_scenario_on_the_copy(name, monkeypatch):
    monkeypatch.setattr(RT, "PagedAllocator", PagedAllocator)
    getattr(RT, name)()


def _op(a, op, rng, live, vocab):
    """One random operation on allocator ``a`` (drawn from ``rng``); returns
    a result comparable across implementations."""
    if op == 0 or not live:
        free = [s for s in range(a.n_slots) if s not in live]
        if not free:
            return None
        slot = int(rng.choice(free))
        p = vocab[int(rng.integers(len(vocab)))]
        got = a.admit(slot, p, int(len(p) + rng.integers(0, 9)))
        if got is not None:
            live[slot] = p
        return got
    slot = int(rng.choice(sorted(live)))
    if op == 1:
        a.release(slot)
        del live[slot]
        return None
    if op == 2:
        return a.register_prefix(slot, live[slot])
    if op == 3:
        return a.trim(slot, int(rng.integers(1, 12)))
    if op == 4:
        blocks = a._owned[slot]
        if not blocks:
            return None
        try:
            return a.ensure_writable(slot, int(rng.integers(len(blocks))))
        except RuntimeError as e:
            return str(e)
    return a.lookup_prefix(live[slot])


@pytest.mark.parametrize("seed", range(12))
def test_state_dict_equals_the_reference_after_every_op(seed):
    rng = np.random.default_rng(seed)
    vocab = [rng.integers(0, 997, size=int(n), dtype=np.int32)
             for n in (4, 5, 8, 9, 12, 16)]
    geom = dict(n_slots=4, n_blocks=int(rng.integers(6, 14)), block_size=4,
                s_max=32)
    mine, ref = PagedAllocator(**geom), RefAllocator(**geom)
    live_m, live_r = {}, {}
    ops = rng.integers(0, 6, size=80)
    rm = np.random.default_rng(seed + 1000)
    rr = np.random.default_rng(seed + 1000)
    for op in ops:
        got = _op(mine, int(op), rm, live_m, vocab)
        want = _op(ref, int(op), rr, live_r, vocab)
        assert got == want
        assert mine.state_dict() == ref.state_dict()
        assert (mine.tab == ref.tab).all()
        assert mine.free_blocks == ref.free_blocks
        mine.check_invariants()
    restored = PagedAllocator(**geom)
    restored.load_state(ref.state_dict())
    assert restored.state_dict() == mine.state_dict()


#: a trace on which the reference allocator's copy-on-write leaks a block:
#: the registry eviction inside ``ensure_writable`` drops the block's pin,
#: the pin is decremented again, and the block ends with ref 0 off the free
#: list (found by the reference's own property test)
LEAKING_TRACE = (20583, (0, 3, 1, 0, 2, 3, 0, 4, 3, 3, 0, 4))


def test_copy_on_write_after_an_eviction_keeps_every_invariant(monkeypatch):
    inner = RT.test_random_traces_hold_invariants.hypothesis.inner_test
    seed, ops = LEAKING_TRACE
    monkeypatch.setattr(RT, "PagedAllocator", RefAllocator)
    with pytest.raises(AssertionError, match="ref=0 free=False"):
        inner(seed, list(ops))
    monkeypatch.setattr(RT, "PagedAllocator", PagedAllocator)
    inner(seed, list(ops))
