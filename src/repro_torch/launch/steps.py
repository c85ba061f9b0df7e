"""Step functions of the continuous-batching engine.

Each ``make_*`` closes over the ModelConfig and returns the callable the
engine invokes. The reference jits these; here they run eagerly under
``torch.inference_mode()`` and update the KV cache in place. The fault-
injection ``poison`` argument of the reference's decode steps is not ported
(fault plans belong to the resilience slice).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def admit_pad_shapes(buckets, s_max: int) -> Tuple[int, ...]:
    """The ONLY prompt pad lengths admission may use, ascending: the declared
    buckets clamped to ``s_max`` plus the big-bucket multiples used for
    overflow prompts (also clamped). ``Engine.bucket_for`` maps a length to
    the smallest member covering it and fails closed on non-membership. The
    largest member is always ``s_max``, so every admissible prompt has a pad
    shape."""
    declared = sorted({min(int(b), int(s_max)) for b in buckets}) or [1]
    big = declared[-1]
    shapes = set(declared)
    m = 1
    while m * big < s_max:
        m += 1
        shapes.add(min(m * big, s_max))
    return tuple(sorted(shapes))


def admit_trace_budget(buckets, s_max: int, n_slots: int) -> int:
    """Number of distinct (pad shape, pow2 group size) admission shapes: the
    engine pads every admission group to one of them."""
    shapes = admit_pad_shapes(buckets, s_max)
    sizes, p = 1, 1
    while p < n_slots:
        p *= 2
        sizes += 1
    return len(shapes) * sizes


def _require_greedy(temperature: float) -> None:
    if temperature > 0.0:
        raise NotImplementedError(
            "sampling at temperature > 0 is not ported yet (it needs the "
            "reference's threefry fold_in / gumbel key schedule)")


def sample_tokens(logits: torch.Tensor, temperature: float, keys=None,
                  positions=None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] -> [B] int32. Greedy only:
    ``temperature > 0`` needs the reference's position-indexed threefry
    Gumbel noise to reproduce its sampled streams and is not ported yet."""
    _require_greedy(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_slot_decode(cfg: ModelConfig) -> Callable:
    """slot_decode(model, cache, token [B], active [B]) -> (logits [B, V],
    aux [B, 2] int32, cache) with ``aux[b] = (greedy, finite)``: the greedy
    argmax and the numeric-health flag (all logits finite) packed into one
    tensor, so a greedy engine reads back once per step."""
    @torch.inference_mode()
    def slot_decode(model, cache, token, active):
        logits, cache = MD.decode_step_slots(cfg, model, cache, token, active)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        return logits, torch.stack([greedy, finite], dim=-1), cache
    return slot_decode


def make_slot_admit(cfg: ModelConfig) -> Callable:
    """Admission: prefill + slot insert + first-token argmax.

    slot_admit(model, cache, tokens [B, S_bucket], lengths [B], slots [B])
    -> (logits [B, V], greedy [B] int32, cache). Rows may be padding (the
    engine pads groups to a power of two): their ``slots`` entry lies outside
    ``[0, n_slots)`` and :func:`repro_torch.models.model.insert_slots` leaves
    them out of the write, so their garbage KV and lengths never land in the
    cache. ``slots`` is a host array."""
    @torch.inference_mode()
    def slot_admit(model, cache, tokens, lengths, slots):
        logits, k_new, v_new = MD.prefill_slots(cfg, model, tokens, lengths)
        cache = MD.insert_slots(cache, slots, k_new, v_new, lengths)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, greedy, cache
    return slot_admit


def make_slot_decode_multi(cfg: ModelConfig, k_steps: int,
                           temperature: float = 0.0) -> Callable:
    """Fused K-step decode: K eager steps with NO host read between them.

    slot_decode_multi(model, cache, token [B], active [B], remaining [B],
    eos [B]) -> (block [K, B, 3] int32, active [B] bool, cache), where
    ``block[s, b] = (token, emitted, finite)``: tokens, their emitted flags
    and the numeric-health lane packed into one tensor, so the engine reads
    back once per block.

    Sampling and the per-slot stop flags stay on the device: a slot whose
    sampled token hits its ``eos`` entry (-1 = none) or exhausts
    ``remaining`` stops advancing ``pos`` and stops emitting, but rides along
    in the batch. The reference skips the forward for the tail of a block in
    which every slot is frozen; deciding that needs a host read, so here the
    K steps always run. Frozen slots emit nothing, so the tokens are the
    same."""
    _require_greedy(temperature)

    @torch.inference_mode()
    def slot_decode_multi(model, cache, token, active, remaining, eos):
        B = token.shape[0]
        block = torch.empty((k_steps, B, 3), dtype=torch.int32,
                            device=token.device)
        tok, act, rem = token.to(torch.int32), active, remaining
        for s in range(k_steps):
            logits, cache = MD.decode_step_slots(cfg, model, cache, tok, act)
            finite = torch.isfinite(logits).all(dim=-1)
            nxt = sample_tokens(logits, temperature)
            emitted = act
            rem = rem - act.to(rem.dtype)
            done = (nxt == eos) | (rem <= 0)
            act = act & ~done
            tok = torch.where(emitted, nxt, tok)
            block[s, :, 0] = nxt
            block[s, :, 1] = emitted.to(torch.int32)
            block[s, :, 2] = finite.to(torch.int32)
        return block, act, cache
    return slot_decode_multi
