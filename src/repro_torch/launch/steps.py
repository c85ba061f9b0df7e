"""Step functions of the continuous-batching engine, and the CUDA graphs that
replay them.

Each ``make_*`` closes over the ModelConfig and returns the callable the
engine invokes: the step's BODY, which runs eagerly under
``torch.inference_mode()`` and updates the KV cache in place. The reference
jits these. The port's counterpart of one jitted call is one replay of a CUDA
graph captured over the body (:class:`StepGraph`): on the card the engine
replays each decode block (:class:`GraphedStep` over
:func:`make_slot_decode_multi`, or :func:`make_slot_decode` for the
step-at-a-time loop) and each admitted prompt (:class:`GraphedAdmit`, one
graph per pad shape at batch 1), and a speculative engine each draft /
verify round (:class:`GraphedRound` over :func:`make_slot_decode_spec`), so
the device, not Python, drives serving.
On the CPU, and in ``chip_smoke.py``'s comparisons on the card, the bodies
run eagerly. The kernels inside a graph are the same hand-written ones.

The decode steps and the speculative round take the reference's
fault-injection ``poison`` mask (``serving.faults``): a ``[B]`` bool whose
True rows get their logits NaN-poisoned after each forward, which the
numeric-health lane then reports. The engine hands its graphs one more
static buffer for it, filled in place before each replay, so a mask never
recaptures a graph; an all-False mask selects the untouched logits, bitwise
the step without it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import threefry as TF
from repro_torch.kernels import ops as kops
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


def _consts(cfg: ModelConfig, cache, consts: Optional[MD.SlotConsts]):
    return MD.slot_consts(cfg, cache) if consts is None else consts


def poison_logits(logits: torch.Tensor,
                  poison: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's ``where(poison[:, None], nan, logits)`` over the
    leading (slot) axis of ``logits`` (``[B, V]`` or a verify's ``[B, T,
    V]``): NaN in the rows of poisoned slots, the other rows' values as they
    are. ``poison`` None (no mask given) returns ``logits`` itself."""
    if poison is None:
        return logits
    mask = poison.reshape(poison.shape + (1,) * (logits.dim() - 1))
    return logits.masked_fill(mask, float("nan"))


def make_slot_decode(cfg: ModelConfig, temperature: float = 0.0,
                     consts: Optional[MD.SlotConsts] = None) -> Callable:
    """slot_decode(model, cache, token [B], active [B], keys [B, 2] = None,
    poison [B] bool = None) -> (logits [B, V], aux [B, 2] int32, cache) with
    ``aux[b] = (token, finite)``: the sampled token (:func:`sample_tokens` at
    ``cache["pos"]`` after the step, the position it will occupy; the greedy
    argmax at ``temperature <= 0``, where ``keys`` may be None) and the
    numeric-health flag (all logits finite) packed into one tensor, so the
    engine reads back once per step at any temperature. The reference's step
    returns the greedy argmax here and samples at T > 0 from the logits on
    the host. ``poison``: the fault-injection mask (:func:`poison_logits`,
    after the forward). ``consts``: the cache's ``model.slot_consts``, built
    once by the engine (default: built at every call)."""
    @torch.inference_mode()
    def slot_decode(model, cache, token, active, keys=None, poison=None):
        logits, cache = MD.decode_step_slots(cfg, model, cache, token, active,
                                             _consts(cfg, cache, consts))
        logits = poison_logits(logits, poison)
        tok = sample_tokens(logits, temperature, keys, cache["pos"])
        finite = torch.isfinite(logits).all(dim=-1).to(torch.int32)
        return logits, torch.stack([tok, finite], dim=-1), cache
    return slot_decode


def _admit_rows_one_by_one(admit_one: Callable, cache, slots):
    """Run ``admit_one(i, slots_d)`` -> logits ``[1, V]`` for every row i of
    an admission group (``slots_d``: the group's slots as a long tensor on
    the cache's device, one copy for the group) and stack the results:
    (logits ``[B, V]``, greedy ``[B]``). Every slot must be real (``0 <=
    slots[i] < n_slots``): the engine never pads a group."""
    n_slots = cache["pos"].shape[0]
    slots_h = torch.as_tensor(slots).tolist()
    if not all(0 <= s < n_slots for s in slots_h):
        raise ValueError(f"admission slots {slots_h} outside [0, {n_slots})")
    slots_d = torch.as_tensor(slots_h, dtype=torch.long).to(
        cache["pos"].device)
    logits = torch.cat([admit_one(i, slots_d) for i in range(len(slots_h))],
                       dim=0)
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


def admit_row(cfg: ModelConfig, consts: MD.SlotConsts) -> Callable:
    """The body that admits ONE prompt into the dense cache, the one an
    admission graph captures: row(model, cache, tokens [1, S_bucket],
    lengths [1], slot [1]) -> logits [1, V], with ``slot`` a long tensor on
    the cache's device (prefill at batch 1, then ``model.insert_slot``)."""
    def row(model, cache, tokens, lengths, slot):
        logits, k_new, v_new = MD.prefill_slots(cfg, model, tokens, lengths,
                                                inv_freq=consts.inv_freq)
        MD.insert_slot(cache, slot, k_new, v_new, lengths)
        return logits
    return row


def admit_row_paged(cfg: ModelConfig, consts: MD.SlotConsts) -> Callable:
    """:func:`admit_row` for the paged pool: row(model, cache, tokens [1,
    S_bucket], lengths [1], slot [1], pos0 [1]) -> logits [1, V]
    (``model.admit_slots_paged``; the slot's table row is read from
    ``cache["tab"]`` on the device)."""
    def row(model, cache, tokens, lengths, slot, pos0):
        logits, _ = MD.admit_slots_paged(cfg, model, cache, tokens, lengths,
                                         slot, pos0, inv_freq=consts.inv_freq)
        return logits
    return row


def make_slot_admit(cfg: ModelConfig,
                    consts: Optional[MD.SlotConsts] = None) -> Callable:
    """Admission: prefill + slot insert + first-token argmax.

    slot_admit(model, cache, tokens [B, S_bucket], lengths [B], slots [B])
    -> (logits [B, V], greedy [B] int32, cache). ``slots`` is a host array
    of B distinct real slots.

    Each real row is prefilled ALONE, at batch 1 and its bucket length, and
    inserted (:func:`admit_row`). So a prompt's admission arithmetic does
    not depend on which other requests share its group: the library's
    matrix products pick their algorithm by the number of rows, and a
    batched prefill gave the same prompt other logits alone than in a group
    of four on the card. The group stays one step call with one readback of
    ``greedy``."""
    @torch.inference_mode()
    def slot_admit(model, cache, tokens, lengths, slots):
        row = admit_row(cfg, _consts(cfg, cache, consts))

        def one(i, slots_d):
            return row(model, cache, tokens[i:i + 1], lengths[i:i + 1],
                       slots_d[i:i + 1])
        logits, greedy = _admit_rows_one_by_one(one, cache, slots)
        return logits, greedy, cache
    return slot_admit


def make_slot_admit_paged(cfg: ModelConfig,
                          consts: Optional[MD.SlotConsts] = None) -> Callable:
    """Admission into the PAGED pool.

    slot_admit_paged(model, cache, tokens [B, S_bucket], lengths [B],
    slots [B], pos0 [B]) -> (logits [B, V], greedy [B] int32, cache).
    ``tokens`` holds each request's SUFFIX (prompt minus its shared-prefix
    rows) and ``pos0`` the shared rows. Each row runs
    :func:`admit_row_paged` alone, at batch 1, as in
    :func:`make_slot_admit`."""
    @torch.inference_mode()
    def slot_admit_paged(model, cache, tokens, lengths, slots, pos0):
        row = admit_row_paged(cfg, _consts(cfg, cache, consts))

        def one(i, slots_d):
            return row(model, cache, tokens[i:i + 1], lengths[i:i + 1],
                       slots_d[i:i + 1], pos0[i:i + 1])
        logits, greedy = _admit_rows_one_by_one(one, cache, slots)
        return logits, greedy, cache
    return slot_admit_paged


def make_slot_decode_multi(cfg: ModelConfig, k_steps: int,
                           temperature: float = 0.0,
                           consts: Optional[MD.SlotConsts] = None) -> Callable:
    """Fused K-step decode: K steps with NO host read between them.

    slot_decode_multi(model, cache, token [B], active [B], remaining [B],
    eos [B], keys [B, 2] = None, poison [B] bool = None) -> (block [K, B, 3]
    int32, active [B] bool, cache), where
    ``block[s, b] = (token, emitted, finite)``: tokens, their emitted flags
    and the numeric-health lane packed into one tensor, so the engine reads
    back once per block. ``poison``: the fault-injection mask, applied
    after each of the K forwards (:func:`poison_logits`).

    Sampling (:func:`sample_tokens` at ``cache["pos"]`` after each step,
    the position the token will occupy; ``keys`` may be None at
    ``temperature <= 0``) and the per-slot stop flags stay on the device: a
    slot whose sampled token hits its ``eos`` entry (-1 = none) or exhausts
    ``remaining`` stops advancing ``pos`` and stops emitting, but rides along
    in the batch. The reference skips the forward for the tail of a block in
    which every slot is frozen (its ``lax.cond``); deciding that needs a host
    read, and a replayed CUDA graph runs what it captured, so here the K
    steps always run. Frozen slots emit nothing, so the tokens are the
    same."""
    @torch.inference_mode()
    def slot_decode_multi(model, cache, token, active, remaining, eos,
                          keys=None, poison=None):
        c = _consts(cfg, cache, consts)
        B = token.shape[0]
        block = torch.empty((k_steps, B, 3), dtype=torch.int32,
                            device=token.device)
        tok, act, rem = token.to(torch.int32), active, remaining
        for s in range(k_steps):
            logits, cache = MD.decode_step_slots(cfg, model, cache, tok, act,
                                                 c)
            logits = poison_logits(logits, poison)
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


def make_slot_decode_spec(cfg: ModelConfig, draft_cfg: ModelConfig,
                          k_draft: int, temperature: float = 0.0,
                          consts: Optional[MD.SlotConsts] = None,
                          draft_consts: Optional[MD.SlotConsts] = None
                          ) -> Callable:
    """The speculative round, ``serving.spec.build_slot_decode_spec``."""
    from repro_torch.serving import spec
    return spec.build_slot_decode_spec(cfg, draft_cfg, k_draft, temperature,
                                       consts, draft_consts)


def make_slot_admit_spec(cfg: ModelConfig, draft_cfg: ModelConfig,
                         consts: Optional[MD.SlotConsts] = None,
                         draft_consts: Optional[MD.SlotConsts] = None,
                         steps=None) -> Callable:
    """Dual-model admission, ``serving.spec.build_slot_admit_spec``."""
    from repro_torch.serving import spec
    return spec.build_slot_admit_spec(cfg, draft_cfg, consts, draft_consts,
                                      steps)


def make_slot_admit_spec_paged(cfg: ModelConfig, draft_cfg: ModelConfig,
                               consts: Optional[MD.SlotConsts] = None,
                               draft_consts: Optional[MD.SlotConsts] = None,
                               steps=None) -> Callable:
    """Dual-model paged admission,
    ``serving.spec.build_slot_admit_spec_paged``."""
    from repro_torch.serving import spec
    return spec.build_slot_admit_spec_paged(cfg, draft_cfg, consts,
                                            draft_consts, steps)


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

def _clone_cache(cache):
    """A scratch copy of a cache, or of a tuple of caches (a speculative
    round's two)."""
    if isinstance(cache, tuple):
        return tuple(_clone_cache(c) for c in cache)
    return {name: t.clone() for name, t in cache.items()}


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the calls :class:`StepGraph` makes.
    ``pool``: the memory pool the capture allocates from (graphs that never
    run at once may share one); ``stream``: the side stream of the warm-up
    and the capture. ``reserved_bytes``: what the capture added to
    ``torch.cuda.memory_reserved`` (the pool's new segments)."""

    def __init__(self, pool, stream: torch.cuda.Stream):
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._pool, self._stream = pool, stream
        self.reserved_bytes = 0

    def warm_up(self, body: Callable, cache, inputs) -> None:
        """Run ``body`` once on a scratch copy of ``cache`` (of each cache of
        a tuple) on the side stream: libraries built and loaded, library
        handles and workspaces made, lazily built constants in place, the
        live caches untouched."""
        scratch = _clone_cache(cache)
        here = torch.cuda.current_stream()
        self._stream.wait_stream(here)
        with torch.cuda.stream(self._stream):
            body(scratch, *inputs)
        here.wait_stream(self._stream)
        torch.cuda.synchronize()

    def capture(self, body: Callable, cache, inputs):
        """Record ``body`` on the live cache; nothing runs."""
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        with torch.cuda.graph(self._graph, pool=self._pool,
                              stream=self._stream):
            out = body(cache, *inputs)
        self.reserved_bytes = torch.cuda.memory_reserved() - before
        return out

    def instantiate(self) -> None:
        self._graph.instantiate()
        torch.cuda.synchronize()

    def replay(self) -> None:
        self._graph.replay()


class StepGraph:
    """One step body replayed from a graph (``graph``: a :class:`CudaGraph`,
    or a stand-in with the same four calls and ``reserved_bytes``), the
    port's counterpart of one call of the reference's jitted step.

    Built in four moves: ``graph.warm_up`` (on a scratch copy of the cache),
    ``graph.capture`` of ``body(cache, *inputs)`` against the static input
    buffers ``inputs`` and the live cache, ``graph.instantiate``, and the
    launch credit: a kernel wrapper counts its launch (``_common.Kernel``)
    only while the graph is captured, so the capture's count delta, by
    kernel and route, is credited at every :meth:`replay` and
    ``ops.launch_counts()`` reads what an eager run reads. The warm-up's
    and the capture's own counts are taken back. The outputs are the
    capture's tensors, rewritten by every replay (read them before the next
    replay of a graph that shares the pool)."""

    def __init__(self, body: Callable, cache, inputs: Sequence[torch.Tensor],
                 graph):
        self.inputs = tuple(inputs)
        self._graph = graph
        counts = kops.route_launch_counts()
        t0 = time.perf_counter()
        graph.warm_up(body, cache, self.inputs)
        warm = kops.route_launch_counts()
        t1 = time.perf_counter()
        self.outputs = graph.capture(body, cache, self.inputs)
        t2 = time.perf_counter()
        graph.instantiate()
        self.warm_up_s, self.capture_s = t1 - t0, t2 - t1
        self.instantiate_s = time.perf_counter() - t2
        self.credit = kops.launch_delta(kops.route_launch_counts(), warm)
        kops.restore_launch_counts(counts)
        self.replays = 0

    def replay(self):
        self._graph.replay()
        kops.credit_launches(self.credit)
        self.replays += 1
        return self.outputs

    def stats(self) -> dict:
        return dict(warm_up_s=self.warm_up_s, capture_s=self.capture_s,
                    instantiate_s=self.instantiate_s, replays=self.replays,
                    reserved_bytes=self._graph.reserved_bytes,
                    launches=sum(n for by_route in self.credit.values()
                                 for n in by_route.values()))


def _load(buffers: Sequence[torch.Tensor], values) -> None:
    """Copy each value into its static buffer (skipped where the caller
    handed the buffer itself)."""
    if len(values) != len(buffers):
        raise ValueError(f"{len(values)} inputs for {len(buffers)} buffers")
    for buf, v in zip(buffers, values):
        if v is not buf:
            buf.copy_(v)


class GraphedStep:
    """A decode step (``make_slot_decode`` or ``make_slot_decode_multi``,
    the same call signature) replayed from one :class:`StepGraph`, for one
    model and one cache, whose tensors' addresses the graph holds.

    ``inputs``: the static buffers, one for each tensor argument after the
    cache (the engine fills them in place and hands them over, so no copy
    is made; other tensors are copied in). Captured at the first call, with
    that call's values in the buffers; a call with another model or cache
    raises. Returns the step's outputs, the graph's tensors."""

    def __init__(self, step: Callable, model, cache,
                 inputs: Sequence[torch.Tensor], new_graph: Callable):
        self._step, self._model, self._cache = step, model, cache
        self._inputs = tuple(inputs)
        self._new_graph = new_graph
        self.graphs: Dict[str, StepGraph] = {}

    def __call__(self, model, cache, *args):
        if model is not self._model or cache is not self._cache:
            raise ValueError("a graphed step replays against the model and "
                             "cache it was built for")
        _load(self._inputs, args)
        g = self.graphs.get("step")
        if g is None:
            step, m = self._step, self._model
            g = self.graphs["step"] = StepGraph(
                lambda c, *a: step(m, c, *a), cache, self._inputs,
                self._new_graph())
        return g.replay()


class GraphedRound:
    """A speculative round (:func:`make_slot_decode_spec`) replayed from one
    :class:`StepGraph` (``graphs["spec round"]``), for one (model, draft)
    pair and their two caches, whose tensors' addresses the graph holds: the
    warm-up runs on scratch copies of both caches, and a round is one
    replay. ``inputs``: the static buffers of token, active, remaining, eos
    and keys (as :class:`GraphedStep`). Returns (block, active, cache,
    draft_cache): the graph's tensors and the live caches."""

    def __init__(self, step: Callable, model, draft, cache, draft_cache,
                 inputs: Sequence[torch.Tensor], new_graph: Callable):
        self._step = step
        self._bound = (model, draft, cache, draft_cache)
        self._inputs = tuple(inputs)
        self._new_graph = new_graph
        self.graphs: Dict[str, StepGraph] = {}

    def __call__(self, model, draft, cache, draft_cache, *args):
        if any(a is not b for a, b in zip((model, draft, cache, draft_cache),
                                          self._bound)):
            raise ValueError("a graphed round replays against the models and "
                             "caches it was built for")
        _load(self._inputs, args)
        g = self.graphs.get("spec round")
        if g is None:
            step = self._step

            def body(caches, *a):
                return step(model, draft, caches[0], caches[1], *a)[:2]
            g = self.graphs["spec round"] = StepGraph(
                body, (cache, draft_cache), self._inputs, self._new_graph())
        block, active = g.replay()
        return block, active, cache, draft_cache


class GraphedAdmit:
    """``make_slot_admit`` / ``make_slot_admit_paged`` (the same call
    signature) for one model and one cache: every row of a group replays the
    graph of its pad shape, which holds :func:`admit_row` (or
    :func:`admit_row_paged`) at batch 1 and is captured at the shape's first
    use; the group's logits are stacked and its greedy tokens taken once, as
    the eager builders do. ``row``: that body. The logits returned are
    copies; the first tokens come from one argmax over the group. ``name``:
    the graphs' key prefix (``"<name> <pad shape>"``; a speculative
    engine's draft model admits as ``"admit draft"``)."""

    def __init__(self, row: Callable, model, cache, new_graph: Callable,
                 name: str = "admit"):
        self._row, self._model, self._cache = row, model, cache
        self._new_graph = new_graph
        self.name = name
        self.graphs: Dict[str, StepGraph] = {}

    def _graph(self, tokens, args) -> StepGraph:
        key = f"{self.name} {tokens.shape[1]}"
        g = self.graphs.get(key)
        if g is None:
            row, m = self._row, self._model
            dev = self._cache["pos"].device
            inputs = [tokens[:1].clone(), args[0][:1].clone(),
                      torch.zeros((1,), dtype=torch.long, device=dev)]
            inputs += [a[:1].clone() for a in args[2:]]
            g = self.graphs[key] = StepGraph(
                lambda c, *a: row(m, c, *a), self._cache, inputs,
                self._new_graph())
        return g

    @torch.inference_mode()
    def __call__(self, model, cache, tokens, lengths, slots, *pos0):
        if model is not self._model or cache is not self._cache:
            raise ValueError("a graphed admission replays against the model "
                             "and cache it was built for")

        def one(i, slots_d):
            g = self._graph(tokens, (lengths, slots_d) + pos0)
            _load(g.inputs, (tokens[i:i + 1], lengths[i:i + 1],
                             slots_d[i:i + 1]) + tuple(p[i:i + 1]
                                                       for p in pos0))
            return g.replay().clone()
        logits, greedy = _admit_rows_one_by_one(one, cache, slots)
        return logits, greedy, cache
