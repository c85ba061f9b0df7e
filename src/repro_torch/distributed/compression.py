"""Distributed compression substrate.

* ``ef_compressed(opt, seed=0)`` — optimizer wrapper implementing
  ERROR-FEEDBACK quantization: the gradient is quantized to int8 (per-leaf
  max-abs scaling, stochastic rounding from a key of the seed, the step and
  the leaf's index), the quantization residual is accumulated into an
  ``ef`` state and added back next step. The inner optimizer only ever sees
  dequantized gradients.

* ``shard_layer_solves(thunks, n_shards)`` — the MergeMoE solve-stage
  executor: per-layer expert-merge solve closures statically sharded over
  ``n_shards`` host threads, the results gathered back in layer order. The
  solves are independent fp64 host computations over replicated
  calibration inputs, so the gathered result is bit-identical to the
  sequential loop for ANY shard count.

The port's copy of the reference's ``repro/distributed/compression.py``.
``quantize`` / ``ef_compressed`` give the reference's bits: a leaf is the
reference's leaf (a layer stack's ``[L, ...]`` whole, so its max-abs scale
is the stack's), its index is its place in JAX's flattening of the
gradient tree (integer leaves counted), and the noise is
``jax.random.uniform`` under the key ``fold_in(fold_in(PRNGKey(seed), step),
index)``, computed by :mod:`repro_torch.core.threefry` bit for bit on any
device. The int8 all-reduce (``compressed_psum``) belongs to the mesh
slice and is not ported yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core import threefry as TF
from repro_torch.optim.optimizers import (Optimizer, _assemble, _diffable,
                                          _state_device, tree_map)

F32 = torch.float32
I8_MAX = 127.0


def quantize(g: torch.Tensor, key: torch.Tensor):
    """Per-tensor max-abs int8 quantization with stochastic rounding: (q
    int8, scale fp32 0-d). ``key``: a threefry key ``[2]``."""
    g = g.to(F32)
    # divided by tensors on g's device: a CUDA division by a host scalar is
    # a multiplication by its reciprocal, which is not the reference's bits
    i8 = torch.tensor(I8_MAX, dtype=F32, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / i8
    scaled = g / scale
    noise = TF.uniform(key.to(g.device), g.numel()).reshape(g.shape) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -I8_MAX, I8_MAX).to(
        torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def ef_compressed(opt: Optimizer, seed: int = 0) -> Optimizer:
    """Wrap ``opt`` with int8 error-feedback gradient compression. State:
    ``{"inner": opt's state, "ef": residuals}`` (fp32, the parameters'
    shapes; ``zeros(())`` for an integer leaf), as the reference's."""

    def init(params):
        ef = tree_map(lambda p: torch.zeros(
            p.shape if _diffable(p) else (), dtype=F32, device=p.device),
            params)
        return {"inner": opt.init(params), "ef": ef}

    def begin(grads, state, step):
        base = TF.fold_in(TF.prng_key(seed, _state_device(grads)),
                          torch.as_tensor(step))
        index = itertools.count()

        def compress(g, r):
            i = next(index)
            if not _diffable(g):
                return g
            corrected = g.to(F32) + r
            q, scale = quantize(corrected, TF.fold_in(base, i))
            deq = dequantize(q, scale)
            r.copy_(corrected - deq)
            return deq

        return opt.begin(tree_map(compress, grads, state["ef"]),
                         state["inner"], step)

    return _assemble(init, begin, opt.leaf,
                     lambda state: opt.leaf_state(state["inner"]),
                     opt.state_factored)


def shard_layer_solves(thunks: Sequence[Callable[[], Any]], n_shards: int
                       ) -> Tuple[List[Any], Dict]:
    """Run the per-layer expert-merge solve closures across ``n_shards``
    worker shards; shard i owns the layers with ``index % n_shards == i``
    (static round-robin, mirroring how the expert axis stripes expert tables
    at serving time). Returns (results in layer order, stats).

    Shards are host threads: the solves are NumPy/LAPACK fp64 (DESIGN.md §2),
    which release the GIL inside BLAS, and every shard reads the same
    replicated calibration reservoir. Because each closure is a deterministic
    function of its (replicated) inputs and results are gathered by index —
    never by completion order — the output is bit-identical to running the
    loop sequentially, whatever ``n_shards`` is. On a multi-host fleet the
    same contract holds with processes instead of threads plus one
    all-gather of the merged tables.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    results: List[Any] = [None] * len(thunks)
    t_shard = [0.0] * n_shards
    errors: List[BaseException] = []

    def worker(rank: int) -> None:
        t0 = time.perf_counter()
        try:
            for i in range(rank, len(thunks), n_shards):
                results[i] = thunks[i]()
        except BaseException as e:        # re-raised on the caller thread
            errors.append(e)
        t_shard[rank] = time.perf_counter() - t0

    if n_shards == 1:
        worker(0)
    else:
        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(n_shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results, {"n_shards": n_shards,
                     "t_shard_s": [round(t, 3) for t in t_shard]}
