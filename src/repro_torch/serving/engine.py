"""Continuous-batching serving engine (PyTorch port).

* **Slots.** The engine owns a persistent KV cache, updated in place. A
  request occupies one slot from admission to completion. Dense layout
  (``kv_layout="dense"``): ``[L, n_slots, rows, nkv, hd]`` + per-slot
  ``pos``; eviction just marks the slot free, stale rows are masked by the
  per-slot causal mask and overwritten by the next occupant.
* **Paged KV (``kv_layout="paged"``).** A flat pool of ``kv_blocks`` blocks
  of ``kv_block`` rows plus a per-slot block table owned by the host-side
  ``serving.paging.PagedAllocator``. Admission reserves a request's whole row
  budget (``prompt + max_new - 1``) up front, full prompt blocks are shared
  copy-free between requests with identical prefixes (``prefix_sharing``;
  registered only after the admission call that wrote them), eviction returns
  blocks to the pool, and admission DEFERS the FIFO head while the pool cannot
  supply its reservation (a deferred request that expires is shed with reason
  ``pool_pressure``). ``kv_dtype="int8"`` stores the pool quantized with
  per-(row, head) fp32 scales. The host table reaches the device as an
  explicit copy before each step call (``_sync_tab``), never inside one.
* **Admission.** Pending requests sit in a heap ordered by
  ``(arrival_time, uid, seq)``. At the top of every engine step each free slot
  claims the next due request, and requests admitted together that share a
  prompt bucket form one admission group: one step call and one readback
  (paged: a row forwards its SUFFIX past the shared-prefix rows, padded to
  the whole prompt's bucket). Inside it each prompt
  is prefilled alone (``steps.make_slot_admit``), so its tokens do not depend
  on which requests share its group.
* **Decode.** ``decode_block`` (K) decode steps run back to back on the
  device with on-device sampling and per-slot stop flags; finished slots
  freeze in place and ride along. The host reads back one packed ``[K, B, 3]``
  block per call. ``decode_block=1`` keeps the step-at-a-time loop (the
  parity reference). With ``dispatch='gather'`` the decode-sized MoE layers go
  through the per-token gather kernel. Int8 expert tables (a model quantized
  with ``core.quant.quantize_model_experts``) go through the ``_q`` kernels.
* **Stop conditions.** Per-request ``max_new_tokens`` and optional
  ``eos_token``, evaluated on the device inside the block; freed slots admit
  at the next block boundary.
* **Deadlines.** Requests carry optional deadlines / TTLs; an expired pending
  request is shed with a reason instead of served, and the pending queue can
  be bounded (``max_pending`` / ``backpressure``).

``EngineConfig`` keeps every field of the reference's. The values this port
does not serve yet RAISE ``NotImplementedError`` at construction, never
silently degrade: ``spec_draft`` (or a draft model), ``mesh``,
``snapshot_every_steps > 0``, a fault plan, and
``trace_guard`` other than ``"off"`` (there is no jit whose retraces a guard
could count, so the port's default is ``"off"``; the reference's is
``"count"``). With ``numeric_sentinel != "off"`` a non-finite logit row raises
``NumericHealthError`` (per-slot quarantine waits for the resilience slice).

The clock is pluggable: ``clock='steps'`` interprets ``arrival_time`` in
decode-step units (deterministic), ``clock='wall'`` in seconds.

Sampling keys, as the reference's: every request gets the key
``fold_in(PRNGKey(seed + 1), uid)`` (JAX's threefry,
:mod:`repro_torch.core.threefry`) at admission, and each token draws Gumbel
noise indexed by the sequence position it will occupy
(``steps.sample_tokens``): the first token at ``pos0 + length`` from the
admission's logits, decode tokens at the post-step ``pos``. So at any
temperature the sampled stream of a (seed, uid, prompt) is the same in the
step loop and the fused block, and equal to the reference's. Sampling runs on
the device: no ``[B, V]`` readback. ``counters`` are the reference's except
in the step-at-a-time loop at ``temperature > 0``: the reference reads back
the sampled tokens and the sentinel lane separately (two host syncs a step),
the port reads one packed ``[B, 2]`` tensor (one).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import errors as ERR
from repro_torch.core import quant as Q
from repro_torch.core import threefry as TF
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.serving.paging import PagedAllocator


@dataclasses.dataclass
class Request:
    """One generation request plus its engine-filled result/telemetry."""
    uid: int
    prompt: np.ndarray                  # [prompt_len] int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    arrival_time: float = 0.0           # steps or seconds, per engine clock
    # latest clock value at which admission may still start (inclusive);
    # ``ttl`` is the relative form (deadline = arrival_time + ttl) and is
    # ignored when ``deadline`` is set. None = wait forever.
    deadline: Optional[float] = None
    ttl: Optional[float] = None
    # engine-filled
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    finish_reason: Optional[str] = None  # "length" | "eos" | "shed"
    # terminal status: "queued" until terminal, then "ok" | "shed"
    status: str = "queued"
    shed_reason: Optional[str] = None    # "deadline" | "pool_pressure"
    # True once admission deferred this request for lack of pool blocks: a
    # later expiry sheds it as "pool_pressure" rather than "deadline"
    deferred: bool = False

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def effective_deadline(self) -> Optional[float]:
        if self.deadline is not None:
            return self.deadline
        if self.ttl is not None:
            return self.arrival_time + self.ttl
        return None


@dataclasses.dataclass
class EngineConfig:
    """Same fields as the reference's ``EngineConfig`` (so call sites and
    serialized configs carry over); see the module docstring for the values
    this slice raises on. Only ``trace_guard`` has another default."""
    arch: str = "qwen3-moe-30b-a3b"
    reduced: bool = True
    n_slots: int = 4
    s_max: int = 128                    # per-slot KV capacity
    prefill_buckets: Sequence[int] = (16, 32, 64)
    temperature: float = 0.0
    seed: int = 0
    # MoE dispatch for the serving path; "gather" = ragged with the decode
    # token counts specialized to the per-token gather kernel, "ragged"
    # forces the grouped kernel everywhere. None keeps the ModelConfig's.
    dispatch: Optional[str] = "gather"
    clock: str = "steps"                # "steps" | "wall"
    # fused decode block size K: decode steps per device block. 1 = the
    # step-at-a-time host loop (parity reference).
    decode_block: int = 8
    # prefill all due same-bucket requests as one batch (False = the
    # batch-of-1 admission loop, kept as the parity reference)
    batch_admission: bool = True
    trace_guard: str = "off"
    spec_draft: Optional[str] = None
    spec_k: int = 4
    kv_layout: str = "dense"
    kv_block: int = 16
    kv_blocks: int = 0
    kv_dtype: str = "bf16"
    prefix_sharing: bool = True
    # "off" ignores the finite lane of the readback block; "count" and
    # "strict" raise NumericHealthError on a non-finite slot
    numeric_sentinel: str = "count"
    # bounded pending queue (0 = unbounded) + backpressure policy when
    # full: "reject_new" raises QueueFullError at submit; "shed_expired"
    # first sheds expired pending requests, then rejects if still full
    max_pending: int = 0
    backpressure: str = "reject_new"
    device_retries: int = 2
    retry_backoff_s: float = 0.0
    mesh: Optional[str] = None
    combine_wire_dtype: str = "fp32"
    snapshot_every_steps: int = 0
    snapshot_dir: Optional[str] = None


def _unsupported(ec: EngineConfig, faults, draft_cfg, draft_params) -> None:
    """Raise for every EngineConfig value this slice does not serve."""
    later = []
    if ec.spec_draft is not None or draft_cfg is not None \
            or draft_params is not None:
        later.append("speculative decoding (spec_draft / draft model)")
    if ec.mesh is not None:
        later.append("mesh serving (expert-parallel slice)")
    if ec.snapshot_every_steps:
        later.append("snapshot_every_steps > 0 (resilience slice)")
    if faults is not None:
        later.append("a fault plan (resilience slice)")
    if ec.trace_guard != "off":
        later.append(f"trace_guard={ec.trace_guard!r} (tooling slice; the "
                     f"port runs eagerly, use 'off')")
    if later:
        raise NotImplementedError(
            "not served by this slice of the PyTorch port: " + "; ".join(later))


class Engine:
    """Continuous-batching engine over a slotted KV cache.

    ``device`` defaults to ``"cuda"`` and is never chosen for the caller:
    without a card, construction with the default raises. ``params`` is a
    :class:`repro_torch.models.model.Model` (default: random weights from
    ``ec.seed``)."""

    def __init__(self, ec: EngineConfig, cfg=None, params=None,
                 draft_cfg=None, draft_params=None, faults=None,
                 device="cuda"):
        self.ec = ec
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch path")
        if ec.snapshot_every_steps is None:    # None == 0 == disabled
            ec.snapshot_every_steps = 0
        _unsupported(ec, faults, draft_cfg, draft_params)
        cfg = cfg if cfg is not None else (
            configs.get(ec.arch).reduced() if ec.reduced
            else configs.get(ec.arch))
        if cfg.moe is not None and ec.dispatch is not None:
            moe = dataclasses.replace(cfg.moe, dispatch=ec.dispatch)
            if ec.dispatch == "gather":
                # the gather ceiling must cover the decode token count
                # (T = n_slots) or big-slot engines would silently fall back
                # to ragged on every decode step
                moe = dataclasses.replace(
                    moe, gather_max_tokens=max(moe.gather_max_tokens,
                                               ec.n_slots))
            cfg = cfg.replace(moe=moe)
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"continuous batching serves token-only families "
                f"(dense/moe), not {cfg.family}")
        if ec.decode_block < 1:
            raise ValueError("decode_block must be >= 1")
        if ec.numeric_sentinel not in ("off", "count", "strict"):
            raise ValueError(f"numeric_sentinel must be 'off', 'count' or "
                             f"'strict', got {ec.numeric_sentinel!r}")
        if ec.backpressure not in ("reject_new", "shed_expired"):
            raise ValueError(f"backpressure must be 'reject_new' or "
                             f"'shed_expired', got {ec.backpressure!r}")
        if ec.max_pending < 0 or ec.device_retries < 0:
            raise ValueError("max_pending and device_retries must be >= 0")
        if ec.combine_wire_dtype not in ("fp32", "int8"):
            raise ValueError(f"combine_wire_dtype must be 'fp32' or 'int8', "
                             f"got {ec.combine_wire_dtype!r}")
        if ec.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{ec.kv_layout!r}")
        if ec.kv_layout == "dense" and ec.kv_dtype != "bf16":
            raise ValueError(
                f"kv_dtype={ec.kv_dtype!r} requires kv_layout='paged' (the "
                f"dense slot cache stores the model dtype)")
        self.cfg = cfg
        self.params = params if params is not None else MD.init(
            cfg, self.device, seed=ec.seed)
        if self.params.device.type != self.device.type:
            raise ValueError(f"params live on {self.params.device}, the engine "
                             f"on {self.device}")

        # host<->device crossing telemetry: device_calls counts step calls,
        # host_syncs counts device->host readbacks, tokens_out counts
        # generated tokens
        self.counters: Dict[str, int] = {
            "device_calls": 0, "host_syncs": 0, "tokens_out": 0, "shed": 0}
        self._buckets = tuple(sorted(set(int(b) for b in ec.prefill_buckets)))
        # the ONLY prompt pad lengths admission may use; bucket_for fails
        # closed on non-membership
        self._pad_shapes = ST.admit_pad_shapes(self._buckets, ec.s_max)
        self._alloc: Optional[PagedAllocator] = None
        self._tab_dirty = False
        if ec.kv_layout == "paged":
            n_blocks = ec.kv_blocks if ec.kv_blocks > 0 else (
                ec.n_slots * ec.s_max // ec.kv_block)
            # the allocator checks s_max % kv_block, init_paged_cache kv_dtype
            self._alloc = PagedAllocator(n_slots=ec.n_slots, n_blocks=n_blocks,
                                         block_size=ec.kv_block,
                                         s_max=ec.s_max)
            self.cache = MD.init_paged_cache(
                cfg, ec.n_slots, ec.s_max, self.device, n_blocks=n_blocks,
                block_size=ec.kv_block, kv_dtype=ec.kv_dtype)
            self._tab_dirty = True
            self._admit_step = ST.make_slot_admit_paged(cfg)
        else:
            self.cache = MD.init_slot_cache(cfg, ec.n_slots, ec.s_max,
                                            self.device,
                                            block_size=ec.kv_block)
            self._admit_step = ST.make_slot_admit(cfg)
        self._decode = ST.make_slot_decode(cfg, ec.temperature)
        self._decode_multi = ST.make_slot_decode_multi(cfg, ec.decode_block,
                                                       ec.temperature)

        self._slot_req: List[Optional[Request]] = [None] * ec.n_slots
        self._last_tok = np.zeros((ec.n_slots,), np.int32)
        self._active = np.zeros((ec.n_slots,), bool)
        # per-slot sampling keys, fold_in(base, uid) assigned at admission
        # (32-bit words in int64, see core.threefry)
        self._key_base = TF.prng_key(ec.seed + 1)
        self._slot_keys = np.zeros((ec.n_slots, 2), np.int64)
        # heap of (arrival_time, uid, seq, Request): admission is FIFO by
        # arrival regardless of submission order. The monotonic ``seq``
        # breaks (arrival, uid) ties so heapq never compares Requests.
        self._pending: List[Tuple[float, int, int, Request]] = []
        self._seq_n = 0
        self._next_uid = 0
        self._step_count = 0
        self._t0: Optional[float] = None
        self._inflight: set = set()
        # requests shed at SUBMIT time (backpressure) waiting to be returned
        # from the next step's finished list
        self._done_early: List[Request] = []

    # ------------------------------------------------------------------ API

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def idle(self) -> bool:
        return (not self._pending and not self._active.any()
                and not self._done_early)

    @property
    def steps(self) -> int:
        """Decode steps taken so far (the 'steps' clock's current time)."""
        return self._step_count

    @property
    def host_dispatches_per_token(self) -> float:
        """Host<->device crossings (step calls + readbacks) per generated
        token so far."""
        c = self.counters
        return (c["device_calls"] + c["host_syncs"]) / max(c["tokens_out"], 1)

    def _validate_request(self, prompt: np.ndarray,
                          max_new_tokens: int) -> None:
        """Reject requests that cannot be served, with the reason spelled
        out, at SUBMISSION time (the only place the caller can react). All
        raises are typed (``core.errors``) and subclass ``ValueError``."""
        if prompt.size == 0:
            raise ERR.RequestValidationError("empty prompt")
        if max_new_tokens < 1:
            raise ERR.RequestValidationError("max_new_tokens must be >= 1")
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ERR.InvalidTokenError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size}) "
                f"(vocab size of the served model); got ids spanning "
                f"[{lo}, {hi}]")
        big = min(max(self._buckets, default=1), self.ec.s_max)
        if prompt.size > self.ec.s_max:
            raise ERR.RequestValidationError(
                f"prompt length {prompt.size} cannot fit any prefill bucket: "
                f"the largest admissible bucket is capped by slot capacity "
                f"s_max={self.ec.s_max} (declared buckets "
                f"{tuple(self._buckets)} top out at {big}); shorten the "
                f"prompt or raise s_max")
        # a request consumes prompt + max_new - 1 KV rows: the FINAL sampled
        # token is emitted but never fed back, so its KV row is never
        # needed. The bound is therefore s_max + 1, not s_max.
        if prompt.size + max_new_tokens > self.ec.s_max + 1:
            raise ERR.RequestValidationError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"needs {prompt.size + max_new_tokens - 1} KV rows, more "
                f"than slot capacity s_max={self.ec.s_max} (the final "
                f"sampled token occupies no row, so the bound is "
                f"prompt + max_new <= s_max + 1)")

    def submit(self, prompt, max_new_tokens: int, eos_token: int | None = None,
               arrival_time: float = 0.0, uid: int | None = None,
               deadline: float | None = None,
               ttl: float | None = None) -> Request:
        """Queue one request. ``deadline``/``ttl`` bound how long it may
        WAIT for admission (engine-clock units); past it the engine sheds
        the request with a reason instead of serving stale work. Raises
        typed errors (``core.errors``): RequestValidationError /
        InvalidTokenError for unservable requests, DuplicateUidError for an
        in-flight uid collision, QueueFullError when the bounded pending
        queue rejects under the backpressure policy."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_request(prompt, max_new_tokens)
        if uid is not None and uid in self._inflight:
            raise ERR.DuplicateUidError(
                f"uid {uid} is already in flight (pending or active): "
                f"in-flight uids must be unique")
        self._apply_backpressure()
        if uid is None:
            uid = self._next_uid
        self._next_uid = max(self._next_uid, uid) + 1
        req = Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token=eos_token, arrival_time=arrival_time,
                      deadline=deadline, ttl=ttl)
        self._enqueue(req)
        return req

    def _enqueue(self, req: Request) -> None:
        if req.uid in self._inflight:
            raise ERR.DuplicateUidError(
                f"uid {req.uid} is already in flight (pending or active)")
        self._inflight.add(req.uid)
        self._seq_n += 1
        heapq.heappush(self._pending,
                       (req.arrival_time, req.uid, self._seq_n, req))

    def _apply_backpressure(self) -> None:
        """Enforce the bounded pending queue. With
        ``backpressure='shed_expired'`` a full queue first sheds every
        already-expired pending request; ``'reject_new'``, and a still-full
        queue after shedding, raises QueueFullError."""
        if not self.ec.max_pending \
                or len(self._pending) < self.ec.max_pending:
            return
        if self.ec.backpressure == "shed_expired":
            now = self._now()
            kept = []
            for entry in self._pending:
                r = entry[-1]
                dl = r.effective_deadline
                if dl is not None and now > dl:
                    self._shed(r, now,
                               "pool_pressure" if r.deferred else "deadline")
                    self._done_early.append(r)
                else:
                    kept.append(entry)
            if len(kept) < len(self._pending):
                self._pending = kept
                heapq.heapify(self._pending)
        if len(self._pending) >= self.ec.max_pending:
            raise ERR.QueueFullError(
                f"pending queue full "
                f"({len(self._pending)}/{self.ec.max_pending}) and "
                f"backpressure policy {self.ec.backpressure!r} could not "
                f"make room")

    def _shed(self, req: Request, now: float, reason: str) -> None:
        """Terminate a pending request without serving it."""
        req.status = "shed"
        req.shed_reason = reason
        req.finish_reason = "shed"
        req.t_finished = now
        self.counters["shed"] += 1
        self._inflight.discard(req.uid)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def step(self, now: float | None = None) -> List[Request]:
        """Admit due requests, run ONE decode step, evict finished. Returns
        the requests that finished during this step. The step-at-a-time
        reference loop; :meth:`step_block` is the production path."""
        now = self._now() if now is None else now
        finished = self._admit(now)
        if self._active.any():
            self._sync_tab()
            _, aux, self.cache = self._decode(
                self.params, self.cache, self._dev(self._last_tok),
                self._dev(self._active), self._dev(self._slot_keys))
            self.counters["device_calls"] += 1
            aux_np = aux.cpu().numpy()       # ONE readback: (token, finite)
            self.counters["host_syncs"] += 1
            slots = np.flatnonzero(self._active)
            self._check_finite(aux_np[slots, 1], slots)
            for slot in slots:
                req = self._slot_req[slot]
                tok = int(aux_np[slot, 0])
                req.out_tokens.append(tok)
                self.counters["tokens_out"] += 1
                self._last_tok[slot] = tok
                if self._is_done(req, tok):
                    self._evict(slot, now)
                    finished.append(req)
        self._step_count += 1
        return finished

    def step_block(self, now: float | None = None) -> List[Request]:
        """Admit due requests, then run ``decode_block`` decode steps in ONE
        device block with one readback. Returns finished requests; their
        ``t_finished`` is the block-start clock plus the inner step they
        stopped at, so step accounting matches the per-step loop."""
        now = self._now() if now is None else now
        finished = self._admit(now)
        K = self.ec.decode_block
        if not self._active.any():
            # nothing to decode: advance one step so arrival admission keeps
            # fine-grained timing while the engine drains the future queue
            self._step_count += 1
            return finished
        n = self.ec.n_slots
        rem = np.zeros((n,), np.int32)
        eos = np.full((n,), -1, np.int32)
        slots = np.flatnonzero(self._active)
        for s in slots:
            req = self._slot_req[s]
            rem[s] = req.max_new_tokens - len(req.out_tokens)
            eos[s] = -1 if req.eos_token is None else req.eos_token
        self._sync_tab()
        block, _, self.cache = self._decode_multi(
            self.params, self.cache, self._dev(self._last_tok),
            self._dev(self._active), self._dev(rem), self._dev(eos),
            self._dev(self._slot_keys))
        self.counters["device_calls"] += 1
        # ONE readback: [K, B, (tok, emit, finite)]
        block_np = block.cpu().numpy()
        self.counters["host_syncs"] += 1
        for s in slots:
            req = self._slot_req[s]
            for j in range(K):
                if not block_np[j, s, 1]:
                    break
                t_j = now + j if self.ec.clock == "steps" else self._now()
                self._check_finite(block_np[j, s, 2:3], [s])
                tok = int(block_np[j, s, 0])
                req.out_tokens.append(tok)
                self.counters["tokens_out"] += 1
                self._last_tok[s] = tok
                if self._is_done(req, tok):
                    self._evict(s, t_j)
                    finished.append(req)
                    break
        self._step_count += K
        return finished

    def run(self, requests: Sequence[Request] | None = None) -> List[Request]:
        """Drive until every pending/submitted request completes."""
        if requests:
            # validate the WHOLE batch before enqueuing anything, so a
            # rejected call leaves the engine exactly as it found it
            seen = set()
            for r in requests:
                self._validate_request(np.asarray(r.prompt, np.int32),
                                       r.max_new_tokens)
                if r.uid in self._inflight or r.uid in seen:
                    raise ERR.DuplicateUidError(
                        f"uid {r.uid} is already in flight (or appears "
                        f"twice in this batch): in-flight uids must be "
                        f"unique")
                seen.add(r.uid)
            for r in requests:
                self._enqueue(r)
        advance = self.step_block if self.ec.decode_block > 1 else self.step
        done: List[Request] = []
        while not self.idle:
            done.extend(advance())
        return sorted(done, key=lambda r: r.uid)

    def expert_weight_dtypes(self) -> Tuple[str, str]:
        """(prefix, suffix or uncompressed) expert-table storage: "int8" for
        a stack of quantized layers, else "bf16" (the reference's names)."""
        def one(key):
            stack = getattr(self.params, key, None)
            if stack is None or not hasattr(stack[0], "moe"):
                return "bf16"
            return "int8" if Q.is_quantized(stack[0].moe) else "bf16"
        return one("stack"), one("stack_c" if hasattr(self.params, "stack_c")
                                 else "stack")

    @property
    def kv_dtype_served(self) -> str:
        """KV storage actually in the cache ("int8" only for the quantized
        paged pool)."""
        return ("int8" if self._alloc is not None
                and self.ec.kv_dtype == "int8" else "bf16")

    @property
    def paging_stats(self) -> Dict[str, int]:
        """Allocator telemetry (prefix hits and rows shared, deferrals,
        registry evictions, copy-on-write copies, free blocks); empty in the
        dense layout."""
        if self._alloc is None:
            return {}
        return dict(self._alloc.stats, free_blocks=self._alloc.free_blocks)

    # ------------------------------------------------------------ internals

    def _sync_tab(self) -> None:
        """Ship the allocator's host block table to the device when it
        changed: an explicit copy issued before a step call, never inside
        one."""
        if self._alloc is None or not self._tab_dirty:
            return
        self.cache["tab"].copy_(torch.from_numpy(self._alloc.tab))
        self._tab_dirty = False

    def _reserve_rows(self, req: Request) -> int:
        """KV rows a request owns for its whole lifetime: every position it
        writes (``prompt + max_new - 1``), reserved in full at admission so
        decode never allocates."""
        return req.n_prompt + req.max_new_tokens - 1

    def _now(self) -> float:
        if self.ec.clock == "steps":
            return float(self._step_count)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def bucket_for(self, n: int) -> int:
        """Prefill pad length for an ``n``-token prompt: the smallest member
        of ``steps.admit_pad_shapes`` covering ``n``. Lengths beyond
        ``s_max`` have no admissible shape and raise (``submit`` rejects
        them up front with the full context; this is the fail-closed
        backstop)."""
        if n > self.ec.s_max:
            raise ValueError(
                f"no prefill bucket fits {n} tokens (s_max={self.ec.s_max})")
        for b in self._pad_shapes:
            if n <= b:
                return b
        raise AssertionError(
            f"admission pad-shape table {self._pad_shapes} covers no "
            f"length <= s_max={self.ec.s_max}; steps.admit_pad_shapes "
            f"broke its own invariant")

    def _check_finite(self, lane, slots) -> None:
        """The finite lane is never ignored unless the sentinel is off: a
        zero raises (quarantining the slot waits for the resilience slice)."""
        if self.ec.numeric_sentinel == "off" or all(lane):
            return
        bad = [int(self._slot_req[s].uid) for s, ok in zip(slots, lane)
               if not ok]
        raise ERR.NumericHealthError(
            f"non-finite logits for uid(s) {bad} at step {self._step_count}")

    def _is_done(self, req: Request, tok: int) -> bool:
        if req.eos_token is not None and tok == req.eos_token:
            req.finish_reason = "eos"
            return True
        if len(req.out_tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _admit(self, now: float) -> List[Request]:
        """Fill free slots with due pending requests (prefill + insert +
        first token), grouping same-bucket admissions. Returns requests that
        finish AT admission (e.g. max_new_tokens == 1) and requests shed
        because their deadline passed while they waited.

        Paged layout: each claim first reserves its row budget with the
        allocator, adopting any registered prefix chain (the shared rows
        shrink the suffix that is forwarded). A failed reservation DEFERS the
        FIFO head (nothing behind it may jump the queue) until eviction
        returns blocks; a deferred request that expires sheds as
        ``pool_pressure``."""
        finished: List[Request] = []
        if self._done_early:
            finished.extend(self._done_early)
            self._done_early.clear()
        free = [s for s in range(self.ec.n_slots) if not self._active[s]]
        claimed: List[Tuple[Request, int, int]] = []
        while self._pending and self._pending[0][0] <= now:
            req = self._pending[0][-1]
            dl = req.effective_deadline
            if dl is not None and now > dl:
                heapq.heappop(self._pending)
                self._shed(req, now,
                           "pool_pressure" if req.deferred else "deadline")
                finished.append(req)
                continue
            if not free:
                break
            shared = 0
            if self._alloc is not None:
                shared = self._alloc.admit(free[0], req.prompt,
                                           self._reserve_rows(req))
                if shared is None:
                    req.deferred = True
                    break                       # pool exhausted: defer head
                self._tab_dirty = True
            heapq.heappop(self._pending)
            claimed.append((req, free.pop(0), shared))
        if not claimed:
            return finished
        # a paged row forwards only its prompt SUFFIX past the shared rows,
        # but padded to the bucket of the WHOLE prompt (the reference pads
        # to the suffix's): on the card the fp32 router product gives a row
        # other bits at 64 rows than among the 256 of a full prefill, so
        # the suffix runs at the full prefill's row count and paged and
        # dense admission give bitwise-equal rows
        if self.ec.batch_admission:
            groups: Dict[int, List[Tuple[Request, int, int]]] = {}
            for req, slot, shared in claimed:
                groups.setdefault(self.bucket_for(req.n_prompt),
                                  []).append((req, slot, shared))
            for bucket in sorted(groups):
                self._admit_group(bucket, groups[bucket], now, finished)
        else:
            for req, slot, shared in claimed:
                self._admit_group(self.bucket_for(req.n_prompt),
                                  [(req, slot, shared)], now, finished)
        return finished

    def _admit_group(self, bucket: int,
                     group: List[Tuple[Request, int, int]],
                     now: float, finished: List[Request]) -> None:
        """Prefill + insert + first token for one bucket's admissions as a
        single step call with one readback. The step prefills each row alone
        (``steps.make_slot_admit``), so the group is not padded. Paged rows
        forward only the prompt SUFFIX past their shared-prefix rows; new
        prefix chains are registered for sharing only AFTER the call that
        wrote them (a same-cycle sharer must never adopt unwritten
        blocks)."""
        B = len(group)
        toks = np.zeros((B, bucket), np.int32)
        lengths = np.ones((B,), np.int32)
        slots = np.zeros((B,), np.int32)
        pos0 = np.zeros((B,), np.int32)
        for i, (req, slot, shared) in enumerate(group):
            suffix = req.prompt[shared:]
            toks[i, :suffix.size] = suffix
            lengths[i] = suffix.size
            slots[i] = slot
            pos0[i] = shared
            # the request's sampling key, from its uid: the sampled stream
            # does not depend on scheduling (module docstring)
            self._slot_keys[slot] = TF.fold_in(self._key_base,
                                               req.uid).numpy()
        self._sync_tab()
        paged_args = (self._dev(pos0),) if self._alloc is not None else ()
        logits, tokens, self.cache = self._admit_step(
            self.params, self.cache, self._dev(toks), self._dev(lengths),
            slots, *paged_args)
        self.counters["device_calls"] += 1
        if self.ec.temperature > 0.0:
            # the first token occupies position pos0 + length (the whole
            # prompt), the index the decode steps use for it too
            tokens = ST.sample_tokens(logits, self.ec.temperature,
                                      self._dev(self._slot_keys[slots]),
                                      self._dev(pos0 + lengths))
        first = tokens[:B].cpu().numpy()
        self.counters["host_syncs"] += 1
        if self._alloc is not None and self.ec.prefix_sharing:
            # the rows exist now; sharing begins at the NEXT admission cycle
            for req, slot, _ in group:
                self._alloc.register_prefix(slot, req.prompt)
        for i, (req, slot, _) in enumerate(group):
            tok = int(first[i])
            req.out_tokens.append(tok)
            self.counters["tokens_out"] += 1
            req.t_admitted = now
            req.t_first_token = now
            self._slot_req[slot] = req
            self._last_tok[slot] = tok
            self._active[slot] = True
            if self._is_done(req, tok):
                self._evict(slot, now)
                finished.append(req)

    def _evict(self, slot: int, now: float, status: str = "ok") -> None:
        req = self._slot_req[slot]
        if req is not None:
            req.t_finished = now
            req.status = status
            self._inflight.discard(req.uid)
        self._slot_req[slot] = None
        self._active[slot] = False
        if self._alloc is not None:
            # blocks return to the pool (registry pins keep shared prefix
            # chains alive); the slot's table row goes to the sentinel, so a
            # frozen slot's writes land in the pool's sink block
            self._alloc.release(slot)
            self._tab_dirty = True


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

def poisson_trace(n_requests: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival times (rate = requests per clock
    unit: decode steps or seconds, matching the engine clock)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    return np.cumsum(gaps)
