"""Serving command line: a Poisson trace through the continuous-batching
engine.

    python -m repro_torch.launch.serve                      # reduced config, on the GPU
    python -m repro_torch.launch.serve --device cpu         # the plain PyTorch path
    python -m repro_torch.launch.serve --full-width --layers 24

``--full-width`` serves the published widths of ``--arch`` with random
weights (``--layers`` cuts the depth so the model fits the card). The
fixed-batch server of the reference needs the non-slot model API and is not
ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.serving import Engine, EngineConfig, poisson_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'; never chosen for you")
    ap.add_argument("--full-width", action="store_true",
                    help="published widths instead of the reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth override (with --full-width)")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="Poisson arrival rate, requests per decode step")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    cfg = cfg if args.full_width else cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    ec = EngineConfig(arch=args.arch, reduced=not args.full_width,
                      n_slots=args.n_slots, s_max=args.s_max,
                      prefill_buckets=(args.prompt_len,))
    eng = Engine(ec, cfg=cfg, device=args.device)
    rng = np.random.default_rng(0)
    arrivals = poisson_trace(args.requests, rate=args.rate, seed=1)
    for i in range(args.requests):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, size=args.prompt_len,
                                dtype=np.int32),
                   max_new_tokens=args.max_new_tokens,
                   arrival_time=float(arrivals[i]))
    t0 = time.perf_counter()
    done = eng.run()
    if eng.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {eng.device}, {eng.ec.n_slots} slots, "
          f"dispatch={eng.cfg.moe.dispatch if eng.cfg.moe else 'dense-mlp'})")
    for r in done[:4]:
        print(f"  req {r.uid}: arrived@{r.arrival_time:.1f} "
              f"admitted@{r.t_admitted:.0f} done@{r.t_finished:.0f} "
              f"[{r.finish_reason}] first tokens {r.out_tokens[:6]}")


if __name__ == "__main__":
    main()
