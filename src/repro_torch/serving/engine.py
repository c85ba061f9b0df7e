"""Continuous-batching serving engine (PyTorch port, dense KV layout).

* **Slots.** The engine owns a persistent slotted KV cache
  (``[L, n_slots, s_max, nkv, hd]`` + per-slot ``pos``), updated in place. A
  request occupies one slot from admission to completion; eviction just marks
  the slot free: stale rows are masked by the per-slot causal mask and
  overwritten by the next occupant.
* **Admission.** Pending requests sit in a heap ordered by
  ``(arrival_time, uid, seq)``. At the top of every engine step each free slot
  claims the next due request, and all requests admitted together that share
  a prompt bucket are prefilled as ONE batch (padded to the next power of
  two) and inserted with one write.
* **Decode.** ``decode_block`` (K) decode steps run back to back on the
  device with on-device sampling and per-slot stop flags; finished slots
  freeze in place and ride along. The host reads back one packed ``[K, B, 3]``
  block per call. ``decode_block=1`` keeps the step-at-a-time loop (the
  parity reference). With ``dispatch='gather'`` the decode-sized MoE layers go
  through the per-token gather kernel.
* **Stop conditions.** Per-request ``max_new_tokens`` and optional
  ``eos_token``, evaluated on the device inside the block; freed slots admit
  at the next block boundary.
* **Deadlines.** Requests carry optional deadlines / TTLs; an expired pending
  request is shed with a reason instead of served, and the pending queue can
  be bounded (``max_pending`` / ``backpressure``).

``EngineConfig`` keeps every field of the reference's. The values this slice
of the port does not serve RAISE ``NotImplementedError`` at construction,
never silently degrade: ``kv_layout="paged"``, ``kv_dtype="int8"``,
``spec_draft`` (or a draft model), ``mesh``, ``temperature > 0``,
``snapshot_every_steps > 0``, a fault plan, and ``trace_guard`` other than
``"off"`` (there is no jit whose retraces a guard could count, so the port's
default is ``"off"``; the reference's is ``"count"``). With
``numeric_sentinel != "off"`` a non-finite logit row raises
``NumericHealthError`` (per-slot quarantine waits for the resilience slice).

The clock is pluggable: ``clock='steps'`` interprets ``arrival_time`` in
decode-step units (deterministic), ``clock='wall'`` in seconds.
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
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD


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
    if ec.kv_layout == "paged":
        later.append("kv_layout='paged' (paged KV slice)")
    if ec.kv_dtype == "int8":
        later.append("kv_dtype='int8' (paged KV slice)")
    if ec.spec_draft is not None or draft_cfg is not None \
            or draft_params is not None:
        later.append("speculative decoding (spec_draft / draft model)")
    if ec.mesh is not None:
        later.append("mesh serving (expert-parallel slice)")
    if ec.temperature > 0.0:
        later.append("temperature > 0 (needs the threefry key schedule)")
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
        if ec.kv_layout != "dense":
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{ec.kv_layout!r}")
        if ec.kv_dtype != "bf16":
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                             f"{ec.kv_dtype!r}")
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
        self.cache = MD.init_slot_cache(cfg, ec.n_slots, ec.s_max, self.device)
        self._admit_step = ST.make_slot_admit(cfg)
        self._decode = ST.make_slot_decode(cfg)
        self._decode_multi = ST.make_slot_decode_multi(cfg, ec.decode_block,
                                                       ec.temperature)

        self._slot_req: List[Optional[Request]] = [None] * ec.n_slots
        self._last_tok = np.zeros((ec.n_slots,), np.int32)
        self._active = np.zeros((ec.n_slots,), bool)
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
            _, aux, self.cache = self._decode(
                self.params, self.cache, self._dev(self._last_tok),
                self._dev(self._active))
            self.counters["device_calls"] += 1
            aux_np = aux.cpu().numpy()       # ONE readback: (greedy, finite)
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
        block, _, self.cache = self._decode_multi(
            self.params, self.cache, self._dev(self._last_tok),
            self._dev(self._active), self._dev(rem), self._dev(eos))
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

    # ------------------------------------------------------------ internals

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
        first token), batching same-bucket admissions. Returns requests that
        finish AT admission (e.g. max_new_tokens == 1) and requests shed
        because their deadline passed while they waited."""
        finished: List[Request] = []
        if self._done_early:
            finished.extend(self._done_early)
            self._done_early.clear()
        free = [s for s in range(self.ec.n_slots) if not self._active[s]]
        claimed: List[Tuple[Request, int]] = []
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
            heapq.heappop(self._pending)
            claimed.append((req, free.pop(0)))
        if not claimed:
            return finished
        if self.ec.batch_admission:
            groups: Dict[int, List[Tuple[Request, int]]] = {}
            for req, slot in claimed:
                groups.setdefault(self.bucket_for(req.n_prompt),
                                  []).append((req, slot))
            for bucket in sorted(groups):
                self._admit_group(bucket, groups[bucket], now, finished)
        else:
            for req, slot in claimed:
                self._admit_group(self.bucket_for(req.n_prompt),
                                  [(req, slot)], now, finished)
        return finished

    def _admit_group(self, bucket: int, group: List[Tuple[Request, int]],
                     now: float, finished: List[Request]) -> None:
        """Prefill + insert + first token for one bucket's admissions as a
        single step call. The batch is padded to the next power of two; pad
        rows carry the slot id ``n_slots``, which ``insert_slots`` leaves out
        of the write, so they never touch the cache."""
        B = len(group)
        Bp = 1
        while Bp < B:
            Bp *= 2
        toks = np.zeros((Bp, bucket), np.int32)
        lengths = np.ones((Bp,), np.int32)
        slots = np.full((Bp,), self.ec.n_slots, np.int32)   # pads: left out
        for i, (req, slot) in enumerate(group):
            toks[i, :req.n_prompt] = req.prompt
            lengths[i] = req.n_prompt
            slots[i] = slot
        _, greedy, self.cache = self._admit_step(
            self.params, self.cache, self._dev(toks), self._dev(lengths),
            slots)
        self.counters["device_calls"] += 1
        first = greedy[:B].cpu().numpy()
        self.counters["host_syncs"] += 1
        for i, (req, slot) in enumerate(group):
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


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

def poisson_trace(n_requests: int, rate: float, seed: int = 0) -> np.ndarray:
    """Cumulative Poisson-process arrival times (rate = requests per clock
    unit: decode steps or seconds, matching the engine clock)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n_requests)
    return np.cumsum(gaps)
