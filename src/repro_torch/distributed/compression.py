"""Distributed compression substrate: the MergeMoE solve-stage executor.

``shard_layer_solves(thunks, n_shards)`` runs the per-layer expert-merge
solve closures statically sharded over ``n_shards`` host threads and gathers
the results back in layer order. The solves are independent fp64 host
computations over replicated calibration inputs, so the gathered result is
bit-identical to the sequential loop for ANY shard count.

The port's copy of ``shard_layer_solves`` from the reference's
``repro/distributed/compression.py`` (pure Python). The reference's int8
error-feedback optimizer wrapper (``ef_compressed``) and int8 all-reduce
(``compressed_psum``) belong to the training and mesh slices and are not
ported yet.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple


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
