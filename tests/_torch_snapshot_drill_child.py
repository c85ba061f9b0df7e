"""Child process of the port's crash-recovery drill (DESIGN.md §12).

Serves the paged engine of the port with periodic snapshots
(``snapshot_every_steps``), the whole trace submitted up front, prints each
finished request the moment it finishes (flushed), and dies hard with
``os._exit(17)`` once the step clock has passed ``--kill-after-steps``:
after at least one periodic snapshot committed, before the trace drains.
The parent (``tests/test_torch_snapshot.py`` on the CPU, ``chip_smoke.py``
on the card) restores from the snapshot directory, finishes the trace and
holds both halves to an uninterrupted run, token for token.

Not a test module (no ``test_`` prefix). Imports the port only.

    PYTHONPATH=src python tests/_torch_snapshot_drill_child.py \\
        --snapshot-dir DIR [--kill-after-steps 12] [--device cpu]
        [--layers N] [--seed S]
"""
import argparse
import json
import os
import sys

import numpy as np

KILL_CODE = 17


def build_trace(vocab: int, seed: int = 3, n_requests: int = 6):
    """Prompt lengths across two buckets, two requests sharing a 16-token
    prefix (paged prefix sharing), staggered arrivals, so admission groups
    some requests and not others and the trace outlives the kill point."""
    rng = np.random.default_rng(seed)
    arrivals = [0.0, 0.0, 0.0, 2.0, 5.0, 9.0, 13.0, 17.0]
    shared = rng.integers(0, vocab, size=16, dtype=np.int64)
    reqs = []
    for i in range(n_requests):
        n = int(rng.integers(4, 28))
        prompt = rng.integers(0, vocab, size=n, dtype=np.int64)
        if i in (1, 4):
            prompt = np.concatenate([shared, prompt[:8]])
        reqs.append({"prompt": prompt,
                     "max_new_tokens": int(rng.integers(4, 12)),
                     "arrival_time": arrivals[i % len(arrivals)]})
    return reqs


def drill_engine_config(snapshot_dir=None, **kw):
    """The drill's EngineConfig: the paged pool, periodic snapshots to
    ``snapshot_dir`` every 4 steps (none without a directory)."""
    from repro_torch.serving import EngineConfig
    base = dict(n_slots=4, s_max=64, prefill_buckets=(16, 32), seed=0,
                decode_block=4, kv_layout="paged", kv_block=8,
                snapshot_every_steps=4 if snapshot_dir else 0,
                snapshot_dir=snapshot_dir)
    base.update(kw)
    return EngineConfig(**base)


def drill_model_config(arch: str = "qwen3-moe-30b-a3b", layers: int = 0):
    """The reduced config in fp32 (``layers`` 0); with ``layers`` > 0 the
    published widths at that depth, in bf16 (the card's form)."""
    from repro_torch import configs
    if layers:
        return configs.get(arch).replace(n_layers=layers)
    return configs.get(arch).reduced().replace(dtype="float32")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshot-dir", required=True)
    ap.add_argument("--kill-after-steps", type=int, default=12)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="0: the reduced fp32 config; N: the published "
                         "widths at depth N")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine's seed (its default weights)")
    args = ap.parse_args()

    import torch
    torch.set_num_threads(1)
    from repro_torch.serving import Engine

    cfg = drill_model_config(layers=args.layers)
    ec = drill_engine_config(args.snapshot_dir, seed=args.seed,
                             **({"reduced": False} if args.layers else {}))
    eng = Engine(ec, cfg=cfg, device=args.device)   # seeded default params
    for t in build_trace(cfg.vocab_size):
        eng.submit(t["prompt"], t["max_new_tokens"],
                   arrival_time=t["arrival_time"])
    while not eng.idle:
        # a finished request is reported at once: terminal requests are the
        # caller's, not snapshot state
        for r in eng.step_block():
            sys.stdout.write(json.dumps(
                {"uid": int(r.uid), "status": r.status,
                 "tokens": [int(t) for t in r.out_tokens]}) + "\n")
            sys.stdout.flush()
        if eng.steps >= args.kill_after_steps:
            # no atexit, no cleanup: only the committed snapshots and the
            # lines flushed above survive
            os._exit(KILL_CODE)
    sys.stdout.write("TRACE DRAINED before the kill point\n")
    sys.exit(3)


if __name__ == "__main__":
    main()
