"""Deterministic fault-injection harness for the serving engine
(DESIGN.md §12), the port's own copy of ``repro/serving/faults.py``: the
same names and the same arithmetic (hashlib and NumPy only), so a plan of
the same seed and specs makes every decision, and writes every trace record,
as the reference's does.

A :class:`FaultPlan` is a SEEDED, pure description of what goes wrong and
when: every fire/no-fire decision is a counter-based hash of
``(seed, site, step, salt)`` — no wall clock, no global RNG state, no
``Date.now``-style nondeterminism anywhere — so the same seed replays the
identical fault trace and every failure mode is a regression test instead
of a war story.

The engine consults the plan at four named sites:

====== ===================== ==========================================
site   kind                  injected effect
====== ===================== ==========================================
decode ``nan_logits``        NaN-poison chosen slots' logits inside the
                             fused decode / spec-verify block (the
                             numeric sentinel must quarantine them)
decode ``transient``         the decode call fails ``fails``
                             times before succeeding (bounded retry)
admit  ``transient``         same, for the admission call
alloc  ``exhaust``           the block allocator reports an empty pool,
                             deferring the FIFO head (deadline/shedding
                             paths under pool pressure)
ckpt   ``corrupt``           deterministic bit-flips over artifact bytes
                             (``tree_digest`` verification must catch)
====== ===================== ==========================================

Each firing appends one record to :attr:`FaultPlan.trace`;
:meth:`FaultPlan.trace_digest` hashes the ordered trace so tests and
benchmarks can assert same-seed runs reproduce the identical fault
sequence bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np

SITES = ("decode", "admit", "alloc", "ckpt")
KINDS = {"decode": ("nan_logits", "transient"),
         "admit": ("transient",),
         "alloc": ("exhaust",),
         "ckpt": ("corrupt",)}

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 scramble round — the same counter-based construction
    the calibration reservoir uses: stateless, platform-independent, and a
    pure function of its integer input."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _hash(seed: int, site: str, step: int, salt: int) -> int:
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (SITES.index(site) + 1))
    h = _splitmix64(h ^ (step & _MASK64))
    return _splitmix64(h ^ (salt & _MASK64))


def _uniform(seed: int, site: str, step: int, salt: int) -> float:
    return _hash(seed, site, step, salt) / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault family. Fires at every step listed in ``steps`` and,
    independently, with probability ``p`` per consulted step (hash-driven,
    so probabilistic firings are still seed-deterministic)."""
    site: str
    kind: str
    steps: Tuple[int, ...] = ()
    p: float = 0.0
    # nan_logits: slots to poison (empty = one hash-picked slot per firing)
    slots: Tuple[int, ...] = ()
    # transient: consecutive injected failures per firing step
    fails: int = 1
    # corrupt: byte positions whose low bit flips (empty = first byte)
    byte_offsets: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites are {SITES}")
        if self.kind not in KINDS[self.site]:
            raise ValueError(f"kind {self.kind!r} is not injectable at site "
                             f"{self.site!r} (valid: {KINDS[self.site]})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} outside [0, 1]")
        if self.fails < 1:
            raise ValueError("fails must be >= 1")


class FaultPlan:
    """Seeded fault schedule consulted by the Engine's hooks.

    Decisions are pure functions of ``(seed, site, step)``; the only
    mutable state is the append-only :attr:`trace` of faults that actually
    FIRED, in consultation order — replaying the same engine trace with the
    same plan seed appends the same records."""

    def __init__(self, seed: int = 0, specs: Tuple[FaultSpec, ...] = ()):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self.trace: List[Dict] = []

    # -- pure fire decisions ------------------------------------------------

    def _fires(self, spec: FaultSpec, step: int, salt: int) -> bool:
        if step in spec.steps:
            return True
        return spec.p > 0.0 and _uniform(self.seed, spec.site, step,
                                         salt) < spec.p

    def _record(self, step: int, site: str, kind: str, **detail) -> None:
        self.trace.append(dict(step=int(step), site=site, kind=kind,
                               **detail))

    # -- site hooks ---------------------------------------------------------

    def poison_mask(self, step: int, k: int, n_slots: int) -> np.ndarray:
        """Per-slot NaN-poison mask for the decode block covering engine
        steps ``[step, step + k)``. A listed step anywhere inside the block
        fires (fused blocks advance the step clock by K per call)."""
        mask = np.zeros((n_slots,), bool)
        for si, spec in enumerate(self.specs):
            if spec.site != "decode" or spec.kind != "nan_logits":
                continue
            hit = [s for s in range(step, step + k)
                   if self._fires(spec, s, salt=si)]
            if not hit:
                continue
            slots = spec.slots or (
                _hash(self.seed, "decode", hit[0], salt=1000 + si)
                % n_slots,)
            for s in slots:
                if 0 <= s < n_slots:
                    mask[s] = True
            self._record(hit[0], "decode", "nan_logits",
                         slots=sorted(int(s) for s in slots
                                      if 0 <= s < n_slots))
        return mask

    def transient_failures(self, site: str, step: int) -> int:
        """Consecutive injected failures for the device call at
        ``(site, step)`` — the engine retries up to its budget."""
        total = 0
        for si, spec in enumerate(self.specs):
            if spec.site != site or spec.kind != "transient":
                continue
            if self._fires(spec, step, salt=si):
                total += spec.fails
                self._record(step, site, "transient", fails=spec.fails)
        return total

    def exhausted(self, step: int) -> bool:
        """True when the allocator pool should report exhaustion at
        ``step``, deferring the FIFO head."""
        for si, spec in enumerate(self.specs):
            if spec.site != "alloc" or spec.kind != "exhaust":
                continue
            if self._fires(spec, step, salt=si):
                self._record(step, "alloc", "exhaust")
                return True
        return False

    def corrupt(self, data: bytes, step: int = 0) -> bytes:
        """Deterministically bit-flip ``data`` (site ``ckpt``). Returns the
        corrupted copy; the input is untouched. With no firing ckpt spec
        the data passes through unchanged."""
        out = bytearray(data)
        for si, spec in enumerate(self.specs):
            if spec.site != "ckpt" or spec.kind != "corrupt":
                continue
            if not self._fires(spec, step, salt=si) or not out:
                continue
            offsets = spec.byte_offsets or (0,)
            for off in offsets:
                out[off % len(out)] ^= 1
            self._record(step, "ckpt", "corrupt",
                         byte_offsets=[int(o) for o in offsets])
        return bytes(out)

    # -- trace identity -----------------------------------------------------

    def counts(self) -> Dict[str, int]:
        """Fired-fault counts by kind (what a degraded-mode bench row must
        record exactly)."""
        out: Dict[str, int] = {}
        for ev in self.trace:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def trace_digest(self) -> str:
        """sha256 over the ordered fault trace — two runs produced the same
        faults iff their digests match."""
        h = hashlib.sha256()
        for ev in self.trace:
            h.update(repr(sorted(ev.items())).encode())
        return h.hexdigest()
