"""Host-side block allocator for the paged KV cache (DESIGN.md §11).

The port's own copy of the reference's ``serving/paging.py`` (NumPy only, no
torch): the behaviour, the stats and the ``state_dict`` format are the
reference's, so one allocator's state loads into the other.

The device holds a flat pool of fixed-size KV blocks
(``[L, n_blocks, block_size, nkv, hd]``); which rows belong to which slot is
pure host bookkeeping: a per-slot block table (``tab``), a free list, and a
per-block refcount. The allocator never touches device memory — it hands the
engine an int32 table to ship alongside the pool, and the device side treats
``n_blocks`` (one past the last real block) as a sentinel whose writes are
discarded and whose gather reads are masked (in the port the pool carries one
extra write-only block at index ``n_blocks`` that takes those writes; see
``models/model.py :: init_paged_cache``).

Prefix sharing is refcount-based: after a request's admission forward has
written its prompt rows, every FULL block strictly below the last prompt
token is registered under the exact bytes of the tokens it covers (no hash —
the key IS the token prefix, so collisions are impossible). A later request
whose prompt starts with a registered chain adopts those blocks read-only
(refcount +1 per sharer) and prefills only the suffix. Registered chains are
pinned by the registry itself (one refcount per entry) and evicted LRU when
admission runs out of free blocks.

Two invariants make sharing safe without device-side copy-on-write:

* registered blocks are FULL prompt blocks strictly below the last prompt
  token, and block boundaries are row boundaries — a sharer's first writable
  row is block-aligned at the end of the shared chain, so its scatters can
  never land in a shared block;
* every slot reserves its whole row budget (prompt + max_new − 1 rows, plus
  ``spec_k`` verify headroom in speculative mode) at admission — decode and
  verify never allocate mid-flight, and speculative rollback is a pure
  position rewind that reuses the already-owned blocks in place.

:meth:`PagedAllocator.ensure_writable` still implements full copy-on-write
bookkeeping (divorce a shared block before writing it) as a safety net; the
engine flow above never triggers it, and the property tests exercise it
directly.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class PagedAllocator:
    """Block-table bookkeeping for one KV pool (shared by the draft pool in
    speculative mode — both pools use the same table, so a prefix shared in
    the full-model pool is shared in the draft pool at the same block ids)."""

    def __init__(self, *, n_slots: int, n_blocks: int, block_size: int,
                 s_max: int, n_shards: int = 1):
        if s_max % block_size:
            raise ValueError(f"s_max={s_max} must be a multiple of "
                             f"kv block size {block_size}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_blocks % n_shards or n_slots % n_shards:
            raise ValueError(
                f"n_blocks={n_blocks} and n_slots={n_slots} must both split "
                f"evenly over n_shards={n_shards}: a sharded pool pins "
                f"slot s to the block range of shard s // (n_slots/n_shards) "
                f"(DESIGN.md §13)")
        self.n_slots = int(n_slots)
        self.nb = int(n_blocks)
        self.bs = int(block_size)
        self.s_max = int(s_max)
        self.mb = s_max // block_size                   # table width
        # mesh serving (DESIGN.md §13): with n_shards > 1 the pool is
        # PARTITIONED — shard ``sh`` owns blocks [sh*nb_l, (sh+1)*nb_l) and
        # slots [sh*slots_per, (sh+1)*slots_per), and every allocation for a
        # slot draws only from its shard's range. That is the invariant the
        # in-program table localization relies on: each data shard's table
        # rows reference only block ids it physically holds.
        self.nsh = int(n_shards)
        self.nb_l = self.nb // self.nsh
        self.slots_per = self.n_slots // self.nsh
        # pop() order is ascending block id within each shard —
        # deterministic across runs
        self._free: List[List[int]] = [
            list(range((sh + 1) * self.nb_l - 1, sh * self.nb_l - 1, -1))
            for sh in range(self.nsh)]
        self.ref = np.zeros(self.nb, np.int64)
        # one sentinel row at index n_slots: admission pads point there so
        # their writes never reach a block a slot owns
        self.tab = np.full((self.n_slots + 1, self.mb), self.nb, np.int32)
        self._owned: Dict[int, List[int]] = {}
        self._registry: "OrderedDict[bytes, Tuple[int, ...]]" = OrderedDict()
        self.stats = {"prefix_hits": 0, "prefix_rows_shared": 0,
                      "registry_evictions": 0, "deferrals": 0,
                      "cow_copies": 0}

    # -- capacity ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return sum(len(f) for f in self._free)

    def blocks_for_rows(self, n_rows: int) -> int:
        return -(-int(n_rows) // self.bs)

    # -- sharding (DESIGN.md §13) ------------------------------------------

    def shard_of_slot(self, slot: int) -> int:
        return int(slot) // self.slots_per

    def shard_of_block(self, block: int) -> int:
        return int(block) // self.nb_l

    def _reg_key(self, shard: int, key: bytes) -> bytes:
        """Registry keys are shard-qualified when the pool is partitioned:
        a chain's blocks live on one shard, so only same-shard slots may
        adopt it. Unsharded pools keep the raw-prefix key (snapshot
        compatibility)."""
        if self.nsh == 1:
            return key
        return shard.to_bytes(4, "little") + key

    # -- prefix registry ---------------------------------------------------

    def lookup_prefix(self, prompt: np.ndarray,
                      shard: int = 0) -> Tuple[int, Tuple[int, ...]]:
        """Longest registered chain covering a strict prefix of ``prompt``
        that lives on ``shard`` (the only shard whose slots could adopt it
        in a partitioned pool; ignored when unsharded).

        Returns ``(shared_rows, blocks)``; ``shared_rows`` is capped below
        ``len(prompt)`` so the admission forward always has at least one
        suffix token to produce the first sampled token's logits from."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        for mm in range((len(prompt) - 1) // self.bs, 0, -1):
            key = self._reg_key(shard, prompt[:mm * self.bs].tobytes())
            chain = self._registry.get(key)
            if chain is not None:
                self._registry.move_to_end(key)
                return mm * self.bs, chain
        return 0, ()

    def register_prefix(self, slot: int, prompt: np.ndarray) -> int:
        """Pin every full prompt block of ``slot`` (strictly below the last
        prompt token) in the registry so later admissions can share it. Must
        be called only AFTER the device call that wrote the rows. Returns
        the number of chain entries added."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        blocks = self._owned.get(slot, [])
        sh = self.shard_of_slot(slot)
        added = 0
        for mm in range(1, min((len(prompt) - 1) // self.bs,
                               len(blocks)) + 1):
            key = self._reg_key(sh, prompt[:mm * self.bs].tobytes())
            if key in self._registry:
                self._registry.move_to_end(key)
                continue
            chain = tuple(blocks[:mm])
            for b in chain:
                self.ref[b] += 1
            self._registry[key] = chain
            added += 1
        return added

    def _evict_registry_one(self, shard: Optional[int] = None) -> bool:
        """Evict the LRU registry chain — restricted to chains whose blocks
        live on ``shard`` when given (evicting another shard's chain cannot
        relieve this shard's pressure)."""
        victim = None
        for key, chain in self._registry.items():       # LRU order
            if shard is None or not chain \
                    or self.shard_of_block(chain[0]) == shard:
                victim = key
                break
        if victim is None:
            return False
        chain = self._registry.pop(victim)
        for b in chain:
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free[self.shard_of_block(b)].append(b)
        self.stats["registry_evictions"] += 1
        return True

    # -- slot lifecycle ----------------------------------------------------

    def admit(self, slot: int, prompt: np.ndarray,
              n_rows: int) -> Optional[int]:
        """Reserve ``n_rows`` KV rows for ``slot``, adopting the longest
        registered prefix chain. Returns the shared prefix length in rows
        (0 when nothing is shared), or None when the pool cannot supply the
        blocks even after LRU registry eviction — the caller defers the
        request and retries later (FIFO head-of-line, so admission order is
        preserved)."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns blocks")
        sh = self.shard_of_slot(slot)
        free = self._free[sh]
        shared_rows, shared = self.lookup_prefix(prompt, sh)
        # Take the adoption refcounts BEFORE evicting: the eviction loop may
        # pop the very registry entries pinning this chain, and an unpinned
        # chain would fall into the free list and be handed back out by the
        # need_new loop below — duplicate block ids in the slot table.
        for b in shared:
            self.ref[b] += 1
        need_new = self.blocks_for_rows(n_rows) - len(shared)
        while len(free) < need_new and self._evict_registry_one(
                sh if self.nsh > 1 else None):
            pass
        if len(free) < need_new:
            for b in shared:
                self.ref[b] -= 1
                if self.ref[b] == 0:
                    free.append(b)
            self.stats["deferrals"] += 1
            return None
        blocks = list(shared)
        for _ in range(need_new):
            b = free.pop()
            self.ref[b] += 1
            blocks.append(b)
        self._owned[slot] = blocks
        self.tab[slot] = self.nb
        self.tab[slot, :len(blocks)] = blocks
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_rows_shared"] += shared_rows
        return shared_rows

    def release(self, slot: int) -> None:
        """Return the slot's blocks to the pool (registry pins keep shared
        chains alive) and point its table row at the sentinel so any write
        the frozen slot still issues on device is dropped."""
        for b in self._owned.pop(slot, []):
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free[self.shard_of_block(b)].append(b)
        self.tab[slot] = self.nb

    def trim(self, slot: int, n_rows: int) -> int:
        """Shrink a slot's reservation to ``n_rows`` rows, releasing the
        tail blocks. The engine's reserve-ahead policy never needs this
        (speculative rollback reuses blocks in place); it exists so the
        allocator supports reclaim-on-rollback policies and is exercised by
        the property tests. Returns the number of blocks released."""
        blocks = self._owned.get(slot)
        if blocks is None:
            return 0
        keep = min(max(self.blocks_for_rows(n_rows), 0), len(blocks))
        dropped = blocks[keep:]
        for b in dropped:
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free[self.shard_of_block(b)].append(b)
        self._owned[slot] = blocks[:keep]
        self.tab[slot, keep:] = self.nb
        return len(dropped)

    def ensure_writable(self, slot: int, block_index: int) -> Tuple[int, int]:
        """Copy-on-write: make table entry ``block_index`` of ``slot``
        exclusively owned. Returns ``(old_block, new_block)``; when they
        differ the CALLER must copy the old block's device contents into the
        new one before writing. The engine never hits the divorce branch
        (sharers' first writable row is block-aligned past the shared
        chain), but the allocator keeps the invariant honest for any policy
        that writes into adopted blocks."""
        blocks = self._owned[slot]
        b = blocks[block_index]
        if self.ref[b] == 1:
            return b, b
        sh = self.shard_of_slot(slot)
        free = self._free[sh]
        while not free and self._evict_registry_one(
                sh if self.nsh > 1 else None):
            pass
        if not free:
            raise RuntimeError("paged KV pool exhausted during copy-on-write")
        nb_ = free.pop()
        self.ref[b] -= 1
        self.ref[nb_] = 1
        blocks[block_index] = nb_
        self.tab[slot, block_index] = nb_
        self.stats["cow_copies"] += 1
        return b, nb_

    def reset(self) -> None:
        """Drop every owner and registry entry (full pool reclaim)."""
        for slot in list(self._owned):
            self.release(slot)
        while self._evict_registry_one():
            pass

    # -- snapshot / restore (DESIGN.md §12) --------------------------------

    def state_dict(self) -> dict:
        """JSON-safe snapshot of the complete allocator state: free list
        (order preserved — it IS the allocation order), refcounts, block
        tables, per-slot ownership, and the prefix registry with its LRU
        order and exact byte keys (hex-encoded)."""
        return {
            # flattened in shard order: shard membership is a pure function
            # of block id, so load_state re-splits losslessly (the format is
            # identical to the unsharded one when n_shards == 1)
            "free": [int(b) for f in self._free for b in f],
            "ref": [int(r) for r in self.ref],
            "tab": self.tab.tolist(),
            "owned": {str(s): [int(b) for b in blocks]
                      for s, blocks in self._owned.items()},
            "registry": [[key.hex(), [int(b) for b in chain]]
                         for key, chain in self._registry.items()],
            "stats": dict(self.stats),
        }

    def load_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`. Restores onto an allocator built
        with the same geometry; a restored allocator is indistinguishable
        from the one that snapshotted (``check_invariants`` holds)."""
        self._free = [[] for _ in range(self.nsh)]
        for b in state["free"]:
            self._free[self.shard_of_block(int(b))].append(int(b))
        self.ref = np.asarray(state["ref"], np.int64)
        self.tab = np.asarray(state["tab"], np.int32)
        self._owned = {int(s): [int(b) for b in blocks]
                       for s, blocks in state["owned"].items()}
        self._registry = OrderedDict(
            (bytes.fromhex(key), tuple(int(b) for b in chain))
            for key, chain in state["registry"])
        self.stats = dict(state["stats"])
        self.check_invariants()

    # -- invariants (asserted by the property tests) -----------------------

    def check_invariants(self) -> None:
        expected = np.zeros(self.nb, np.int64)
        for blocks in self._owned.values():
            for b in blocks:
                expected[b] += 1
        for chain in self._registry.values():
            for b in chain:
                expected[b] += 1
        assert (expected == self.ref).all(), "refcount drift"
        free = [b for f in self._free for b in f]
        assert len(set(free)) == len(free), "double-freed block"
        free_set = set(free)
        for sh, f in enumerate(self._free):
            for b in f:
                assert self.shard_of_block(b) == sh, (
                    f"block {b} on shard {sh}'s free list, belongs to "
                    f"{self.shard_of_block(b)}")
        for b in range(self.nb):
            assert (self.ref[b] == 0) == (b in free_set), (
                f"block {b}: ref={self.ref[b]} free={b in free_set}")
        for slot, blocks in self._owned.items():
            assert len(set(blocks)) == len(blocks), (
                f"slot {slot} owns a block twice: {blocks}")
            for b in blocks:
                assert self.shard_of_block(b) == self.shard_of_slot(slot), (
                    f"slot {slot} (shard {self.shard_of_slot(slot)}) owns "
                    f"block {b} of shard {self.shard_of_block(b)}")
            assert list(self.tab[slot, :len(blocks)]) == list(blocks)
            assert (self.tab[slot, len(blocks):] == self.nb).all()
        assert (self.tab[self.n_slots] == self.nb).all(), "sentinel row"
