"""Self-speculative decoding: the MergeMoE-compressed model drafts, the full
model verifies, on the device (the port of ``repro/serving/spec.py``).

MergeMoE fits its merged experts to the full model's expert OUTPUTS, which is
what a draft needs: a cheap forward whose next-token choice is close to the
full model's. Drafts are verified, never trusted: every committed token is a
full-model sample, so spec decode is token for token plain full-model decode
at any temperature.

One round (:func:`build_slot_decode_spec`), one CUDA-graph replay on the card
(``launch.steps.GraphedRound``):

1. DRAFT: ``k_draft`` decode steps of the draft over all slots, each
   proposal sampled with ``steps.sample_tokens`` at the draft cache's
   post-step ``pos``.
2. VERIFY: the full model scores the last committed token and the K
   proposals in one multi-position forward (``model.verify_step_slots``)
   and samples every position under the same (key, position) noise.
3. ACCEPT / ROLLBACK: the longest matching prefix (:func:`accept_drafts`);
   both caches' ``pos`` are written in place to the committed length. The
   rows past it hold rejected KV that the per-slot mask hides and the next
   round overwrites.

Exactness without luck: a verify row is bitwise the decode row of its
position (``model.verify_step_slots``' contract), so the committed tokens,
and the K/V rows under them, are the plain engine's, and each round starts
from the plain engine's state.

Import direction: this module imports the models and ``launch.steps``;
``launch.steps``' ``make_slot_*_spec`` import this module when called.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig

I32 = torch.int32


def accept_drafts(drafts: torch.Tensor, verify: torch.Tensor,
                  active: torch.Tensor, remaining: torch.Tensor,
                  eos: torch.Tensor, k_draft: int):
    """Longest-matching-prefix acceptance with the fused block's stop flags,
    the reference's rule, on the device with no host read.

    drafts ``[B, K]`` proposals d_1..d_K; verify ``[B, K+1]`` full-model
    samples v_0..v_K (v_j scored after the draft prefix d_1..d_j); active
    ``[B]`` bool; remaining ``[B]`` budget; eos ``[B]`` stop token (-1 =
    none).

    v_j is a candidate when every earlier draft matched (d_i == v_{i-1} for
    i <= j), so v_0 always is: a round commits at least one token. At most K
    candidates: the draft cache holds no row for d_K. A candidate is
    EMITTED only while the slot is active, within budget, and no earlier
    candidate was eos. Returns (emitted ``[B, K]`` bool, n_commit ``[B]``,
    n_match ``[B]`` (accepted drafts, 0 for inactive slots), still_active
    ``[B]`` bool), int32 counts."""
    K = int(k_draft)
    cand = verify[:, :K]
    match = (drafts == cand).to(I32)
    n_match = torch.cumprod(match, dim=1).sum(dim=1).to(I32)
    n_acc = torch.clamp(n_match + 1, max=K)
    idx = torch.arange(K, device=drafts.device)[None, :]
    is_eos = (cand == eos[:, None]) & (eos[:, None] >= 0)
    eos_before = torch.cumsum(is_eos.to(I32), dim=1) - is_eos.to(I32)
    emitted = ((idx < n_acc[:, None]) & (idx < remaining[:, None])
               & (eos_before == 0) & active[:, None])
    n_commit = emitted.to(I32).sum(dim=1).to(I32)
    hit_eos = (emitted & is_eos).any(dim=1)
    still = active & ~hit_eos & (remaining - n_commit > 0)
    return emitted, n_commit, n_match * active.to(I32), still


def build_slot_decode_spec(cfg: ModelConfig, draft_cfg: ModelConfig,
                           k_draft: int, temperature: float = 0.0,
                           consts: Optional[MD.SlotConsts] = None,
                           draft_consts: Optional[MD.SlotConsts] = None
                           ) -> Callable:
    """The draft / verify round (engine entry:
    ``steps.make_slot_decode_spec``).

    slot_decode_spec(model, draft, cache, draft_cache, token [B], active
    [B], remaining [B], eos [B], keys [B, 2] = None) -> (block [K+1, B, 3]
    int32, active [B] bool, cache, draft_cache), both caches updated in
    place (``pos`` included). Rows 0..K-1 of ``block`` are ``(token,
    emitted, finite)``, the ``make_slot_decode_multi`` contract, with the
    finite lane over the VERIFY logits (committed tokens are verify
    samples); row K is ``(n_match, drafted, 1)`` per slot: the whole round
    reads back once. ``consts`` / ``draft_consts``: each cache's
    ``model.slot_consts`` (default: built at every call). The reference's
    ``poison`` argument (fault injection) belongs to the resilience slice
    and is not ported. No host read, so a CUDA graph captures the round."""
    K = int(k_draft)
    if K < 1:
        raise ValueError(f"k_draft must be >= 1, got {k_draft}")

    @torch.inference_mode()
    def slot_decode_spec(model, draft, cache, draft_cache, token, active,
                         remaining, eos, keys=None):
        c = ST._consts(cfg, cache, consts)
        dc = ST._consts(draft_cfg, draft_cache, draft_consts)
        pos = cache["pos"]
        t0 = token.to(I32)
        # 1. draft: no stop flags inside the draft, acceptance applies them
        # to the committed stream
        tok, drafts = t0, []
        for _ in range(K):
            logits, draft_cache = MD.decode_step_slots(
                draft_cfg, draft, draft_cache, tok, active, dc)
            tok = ST.sample_tokens(logits, temperature, keys,
                                   draft_cache["pos"])
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                     # [B, K]
        # 2. verify [t0, d_1..d_K], each position sampled as the decode step
        # samples it (its logits rows, its noise at position pos + 1 + t)
        vlogits, cache = MD.verify_step_slots(
            cfg, model, cache, torch.cat([t0[:, None], drafts], dim=1), c)
        verify = torch.stack(
            [ST.sample_tokens(vlogits[:, t], temperature, keys, pos + 1 + t)
             for t in range(K + 1)], dim=1)                     # [B, K+1]
        finite = torch.isfinite(vlogits[:, :K]).all(dim=-1)     # [B, K]
        # 3. accept / rollback: pos = the committed length, in both caches
        emitted, n_commit, n_match, still = accept_drafts(
            drafts, verify, active, remaining, eos, K)
        new_pos = pos + n_commit
        cache["pos"].copy_(new_pos)
        draft_cache["pos"].copy_(new_pos)
        block = torch.empty((K + 1,) + tuple(t0.shape) + (3,), dtype=I32,
                            device=t0.device)
        block[:K, :, 0] = verify[:, :K].t()
        block[:K, :, 1] = emitted.t().to(I32)
        block[:K, :, 2] = finite.t().to(I32)
        block[K, :, 0] = n_match
        block[K, :, 1] = active.to(I32) * K
        block[K, :, 2] = 1
        return block, still, cache, draft_cache

    return slot_decode_spec


def dual_admit(admit: Callable, admit_draft: Callable) -> Callable:
    """Admission into both caches from two single-model admission steps
    (``steps.make_slot_admit`` / ``make_slot_admit_paged`` or their
    ``GraphedAdmit``\\ s): slot_admit_spec(model, draft, cache, draft_cache,
    tokens, lengths, slots, *pos0) -> (logits [B, V], greedy [B], cache,
    draft_cache). Both models prefill the same rows (each row alone) into
    their own cache; the logits and the first tokens are the FULL model's:
    the draft never decides a committed token."""
    def slot_admit_spec(model, draft, cache, draft_cache, tokens, lengths,
                        slots, *pos0):
        logits, greedy, cache = admit(model, cache, tokens, lengths, slots,
                                      *pos0)
        _, _, draft_cache = admit_draft(draft, draft_cache, tokens, lengths,
                                        slots, *pos0)
        return logits, greedy, cache, draft_cache
    return slot_admit_spec


def build_slot_admit_spec(cfg: ModelConfig, draft_cfg: ModelConfig,
                          consts: Optional[MD.SlotConsts] = None,
                          draft_consts: Optional[MD.SlotConsts] = None,
                          steps: Optional[Tuple[Callable, Callable]] = None
                          ) -> Callable:
    """Dual-model admission into dense slot caches (engine entry:
    ``steps.make_slot_admit_spec``): :func:`dual_admit` over
    ``steps.make_slot_admit`` of each model, or over ``steps`` (the
    engine's graphed pair on the card). The reference samples the first
    token inside; here, as in the port's single-model admission, the
    greedy token comes back and the engine samples at temperature > 0 from
    the full model's logits."""
    return dual_admit(*(steps or (ST.make_slot_admit(cfg, consts),
                                  ST.make_slot_admit(draft_cfg,
                                                     draft_consts))))


def build_slot_admit_spec_paged(cfg: ModelConfig, draft_cfg: ModelConfig,
                                consts: Optional[MD.SlotConsts] = None,
                                draft_consts: Optional[MD.SlotConsts] = None,
                                steps: Optional[Tuple[Callable, Callable]]
                                = None) -> Callable:
    """:func:`build_slot_admit_spec` over paged pools (extra argument
    ``pos0``, the shared-prefix rows, as ``steps.make_slot_admit_paged``).
    The engine ships one allocator table to both pools, so a prefix shared
    in the full model's pool is shared in the draft's at the same block
    ids."""
    return dual_admit(*(steps or (ST.make_slot_admit_paged(cfg, consts),
                                  ST.make_slot_admit_paged(draft_cfg,
                                                           draft_consts))))
