"""Step functions of the continuous-batching engine.

Each ``make_*`` closes over the ModelConfig and returns the callable the
engine invokes. The reference jits these; here they run eagerly under
``torch.inference_mode()`` and update the KV cache in place. The fault-
injection ``poison`` argument of the reference's decode steps is not ported
(fault plans belong to the resilience slice).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import threefry as TF
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


def sample_tokens(logits: torch.Tensor, temperature: float,
                  keys: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] -> [B] int32, the reference's
    rule. ``temperature <= 0``: greedy argmax (keys and positions unused).
    ``temperature > 0``: Gumbel-max under the reference's position-indexed
    key schedule, ``argmax(logits / T + gumbel(fold_in(keys[b],
    positions[b])))`` on JAX's threefry (:mod:`repro_torch.core.threefry`),
    where ``positions[b]`` is the sequence position the sampled token will
    occupy. The noise depends on (key, position) only, so every program that
    samples a position (admission, the step loop, the fused block) draws the
    same. keys: ``[B, 2]`` 32-bit words in int64 (per-slot request keys);
    positions: ``[B]``. Runs on the logits' device. The division is by a
    tensor: on CUDA, PyTorch divides by a Python scalar by multiplying with
    its reciprocal, which rounds otherwise than the reference."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None or positions is None:
        raise ValueError("sampling at temperature > 0 needs per-row keys and "
                         "positions")
    dev = logits.device
    noise = TF.gumbel(TF.fold_in(keys.to(dev, torch.int64),
                                 positions.to(dev, torch.int64)),
                      logits.shape[-1])
    lf = logits.to(F32)
    return torch.argmax(lf / torch.full_like(lf, temperature) + noise,
                        dim=-1).to(torch.int32)


def make_slot_decode(cfg: ModelConfig, temperature: float = 0.0) -> Callable:
    """slot_decode(model, cache, token [B], active [B], keys [B, 2] = None)
    -> (logits [B, V], aux [B, 2] int32, cache) with ``aux[b] = (token,
    finite)``: the sampled token (:func:`sample_tokens` at
    ``cache["pos"]`` after the step, the position it will occupy; the greedy
    argmax at ``temperature <= 0``, where ``keys`` may be None) and the
    numeric-health flag (all logits finite) packed into one tensor, so the
    engine reads back once per step at any temperature. The reference's step
    returns the greedy argmax here and samples at T > 0 from the logits on
    the host."""
    @torch.inference_mode()
    def slot_decode(model, cache, token, active, keys=None):
        logits, cache = MD.decode_step_slots(cfg, model, cache, token, active)
        tok = sample_tokens(logits, temperature, keys, cache["pos"])
        finite = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        return logits, torch.stack([tok, finite], dim=-1), cache
    return slot_decode


def _admit_rows_one_by_one(admit_one: Callable, cache, slots):
    """Run ``admit_one(i)`` -> logits ``[1, V]`` for every row i of an
    admission group and stack the results: (logits ``[B, V]``, greedy
    ``[B]``). Every slot must be real (``0 <= slots[i] < n_slots``): the
    engine never pads a group."""
    n_slots = cache["pos"].shape[0]
    slots = torch.as_tensor(slots).tolist()
    if not all(0 <= s < n_slots for s in slots):
        raise ValueError(f"admission slots {slots} outside [0, {n_slots})")
    logits = torch.cat([admit_one(i) for i in range(len(slots))], dim=0)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


def make_slot_admit(cfg: ModelConfig) -> Callable:
    """Admission: prefill + slot insert + first-token argmax.

    slot_admit(model, cache, tokens [B, S_bucket], lengths [B], slots [B])
    -> (logits [B, V], greedy [B] int32, cache). ``slots`` is a host array
    of B distinct real slots.

    Each real row is prefilled ALONE, at batch 1 and its bucket length, and
    inserted. So a prompt's admission arithmetic does not depend on which
    other requests share its group: the library's matrix products pick their
    algorithm by the number of rows, and a batched prefill gave the same
    prompt other logits alone than in a group of four on the card. The group
    stays one step call with one readback of ``greedy``."""
    @torch.inference_mode()
    def slot_admit(model, cache, tokens, lengths, slots):
        def one(i):
            logits, k_new, v_new = MD.prefill_slots(
                cfg, model, tokens[i:i + 1], lengths[i:i + 1])
            MD.insert_slots(cache, slots[i:i + 1], k_new, v_new,
                            lengths[i:i + 1])
            return logits
        logits, greedy = _admit_rows_one_by_one(one, cache, slots)
        return logits, greedy, cache
    return slot_admit


def make_slot_admit_paged(cfg: ModelConfig) -> Callable:
    """Admission into the PAGED pool.

    slot_admit_paged(model, cache, tokens [B, S_bucket], lengths [B],
    slots [B], pos0 [B]) -> (logits [B, V], greedy [B] int32, cache).
    ``tokens`` holds each request's SUFFIX (prompt minus its shared-prefix
    rows) and ``pos0`` the shared rows. Each row runs
    :func:`repro_torch.models.model.admit_slots_paged` alone, at batch 1, as
    in :func:`make_slot_admit`."""
    @torch.inference_mode()
    def slot_admit_paged(model, cache, tokens, lengths, slots, pos0):
        def one(i):
            logits, _ = MD.admit_slots_paged(
                cfg, model, cache, tokens[i:i + 1], lengths[i:i + 1],
                slots[i:i + 1], pos0[i:i + 1])
            return logits
        logits, greedy = _admit_rows_one_by_one(one, cache, slots)
        return logits, greedy, cache
    return slot_admit_paged


def make_slot_decode_multi(cfg: ModelConfig, k_steps: int,
                           temperature: float = 0.0) -> Callable:
    """Fused K-step decode: K eager steps with NO host read between them.

    slot_decode_multi(model, cache, token [B], active [B], remaining [B],
    eos [B], keys [B, 2] = None) -> (block [K, B, 3] int32, active [B] bool,
    cache), where
    ``block[s, b] = (token, emitted, finite)``: tokens, their emitted flags
    and the numeric-health lane packed into one tensor, so the engine reads
    back once per block.

    Sampling (:func:`sample_tokens` at ``cache["pos"]`` after each step,
    the position the token will occupy; ``keys`` may be None at
    ``temperature <= 0``) and the per-slot stop flags stay on the device: a
    slot whose sampled token hits its ``eos`` entry (-1 = none) or exhausts
    ``remaining`` stops advancing ``pos`` and stops emitting, but rides along
    in the batch. The reference skips the forward for the tail of a block in
    which every slot is frozen; deciding that needs a host read, so here the
    K steps always run. Frozen slots emit nothing, so the tokens are the
    same."""
    @torch.inference_mode()
    def slot_decode_multi(model, cache, token, active, remaining, eos,
                          keys=None):
        B = token.shape[0]
        block = torch.empty((k_steps, B, 3), dtype=torch.int32,
                            device=token.device)
        tok, act, rem = token.to(torch.int32), active, remaining
        for s in range(k_steps):
            logits, cache = MD.decode_step_slots(cfg, model, cache, tok, act)
            finite = torch.isfinite(logits).all(dim=-1)
            # frozen rows sample garbage that is never emitted
            nxt = sample_tokens(logits, temperature, keys, cache["pos"])
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
