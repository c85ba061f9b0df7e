#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                 # one NVIDIA GPU (sm_90), ~31 GB of weights
    python3 chip_smoke.py --layers 48     # the full depth of qwen3-moe-30b-a3b, ~61 GB

Needs CUDA and ``nvcc``; exits non-zero without them. Phases, each printing
one JSON line:

  env       what it runs on (repro_torch.env.probe)
  build     compiles the CUDA kernels from src/repro_torch/kernels/csrc
  rehearse  the serve trace on the reduced config: the engine on the card (CUDA
            kernels) against the same engine on the CPU (plain PyTorch), token
            for token, and the admission shapes the trace produces
  kernels   each kernel against its plain PyTorch version on the card: the case
            list of tests/test_torch_kernels.py, then the serve phase's shapes
            at full width, timed
  contracts gather == ragged and fused-K == step-at-a-time on logits, bitwise
  serve     qwen3-moe-30b-a3b at full width (depth cut to --layers), bf16,
            random weights from a seed, 16 requests on a Poisson trace through
            the continuous-batching engine: uncompressed, then merged
            (M = N/2 on the suffix); then the same trace with decode_block=1
            and with dispatch="ragged" at --variant-layers

then a ``{"kernels": [...]}`` line (times, bounds and the serve phase's launch
counts), the card's name and power limit, and ``{"ok": true, ...}`` last. Any
failing check raises: nothing is caught and no kernel failure is answered by
the plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
#: published peaks of one H100 SXM (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TABLE = {
    "gather_swiglu": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gather_swiglu.cu",
        replaces="src/repro/kernels/decode_moe.py:56"),
    "grouped_swiglu": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/grouped_swiglu.cu",
        replaces="src/repro/kernels/grouped_mlp.py:103"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def tol_for(dtype, want: torch.Tensor):
    """(rtol, atol, words). fp32: only the order of the fp32 sums differs
    (sequential fmaf against the library's blocked products). bf16: two ulps
    at the output's scale, one for a flipped rounding of an intermediate row
    and one for the final rounding."""
    scale = max(float(want.float().abs().max()), 1e-6) if want.numel() else 1.0
    if dtype == torch.float32:
        return 1e-4, 2e-5 * scale, "rtol 1e-4, atol 2e-5*max|y| (fp32 sum order)"
    return 0.0, 2 * scale / 128, "atol 2 bf16 ulps of max|y|"


def compare(name, got, want, dtype):
    torch.cuda.synchronize()
    rtol, atol, words = tol_for(dtype, want)
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    check(ok, f"{name}: kernel disagrees with its plain version, "
              f"max abs err {err} ({words})")
    return err, words


def tables(gen, E, d, f, dtype, dev, live=None):
    ws = [torch.randn((E, d, f), generator=gen, device=dev) * 0.2,
          torch.randn((E, d, f), generator=gen, device=dev) * 0.2,
          torch.randn((E, f, d), generator=gen, device=dev) * 0.2]
    if live is not None:
        for w in ws:
            w[live:] = 0
    return [w.to(dtype).contiguous() for w in ws]


def case_list(dev):
    """The case list of tests/test_torch_kernels.py at the reduced shapes."""
    from repro_torch.kernels import decode_moe, grouped_mlp
    gen = torch.Generator(device=dev).manual_seed(42)
    grouped = {
        "empty-middle": [10, 0, 37, 17], "single-expert": [64],
        "tiny-and-dominant": [1, 1, 1, 1, 60], "block-aligned": [16, 16, 16, 16],
        "empty-first": [0, 10], "empty-last": [10, 0],
        "leading-empties": [0, 0, 16], "trailing-empties": [5, 0, 0, 0],
        "empty-run-middle": [3, 0, 0, 3], "all-but-one-empty": [0, 0, 0, 0, 64],
        "post-merge": [40, 0, 24, 0, 16, 0, 8, 0], "T-zero": [0, 0, 0, 0],
        "odd-widths": [3, 0, 9],
    }
    gather = {
        "decode-shape": (4, 24, 32, 8, 2, None, None),
        "single-token-single-expert": (1, 16, 16, 4, 1, None, None),
        "k3": (8, 32, 48, 8, 3, None, None),
        "tiny-table": (3, 16, 32, 2, 2, None, None),
        "duplicate-ids": (2, 16, 16, 4, 2, [[1, 1], [2, 0]], None),
        "out-of-range-ids": (2, 16, 16, 4, 2, [[7, 0], [1, -7]], None),
        "hetero-pad-rows": (4, 24, 32, 8, 2, None, 5),
        "T-zero": (0, 16, 16, 4, 2, None, None),
        "reduced-config": (4, 64, 32, 8, 2, None, None),
        "odd-widths": (3, 23, 31, 4, 2, None, None),
    }
    n = 0
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        for name, sizes in grouped.items():
            d, f = (23, 31) if name == "odd-widths" else (24, 32)
            E, T = len(sizes), sum(sizes)
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            wg, wu, wd = tables(gen, E, d, f, dtype, dev)
            gs = torch.tensor(sizes, device=dev)
            got = grouped_mlp.grouped_swiglu(x, wg, wu, wd, gs)
            err, _ = compare(f"grouped_swiglu[{name},{key}]", got,
                             grouped_mlp.plain(x, wg, wu, wd, gs), dtype)
            worst[key] = max(worst[key], err)
            n += 1
        for name, (T, d, f, E, k, idx, live) in gather.items():
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            wg, wu, wd = tables(gen, E, d, f, dtype, dev, live=live)
            if idx is None:
                idx = torch.randint(0, live or E, (T, k), generator=gen,
                                    device=dev)
            else:
                idx = torch.tensor(idx, device=dev)
            w = torch.softmax(torch.randn((T, k), generator=gen, device=dev), -1)
            got = decode_moe.gather_swiglu(x, wg, wu, wd, idx.to(torch.int32), w)
            err, _ = compare(f"gather_swiglu[{name},{key}]", got,
                             decode_moe.plain(x, wg, wu, wd, idx, w), dtype)
            worst[key] = max(worst[key], err)
            n += 1
    return n, worst


def time_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bound_ms(dtype, n_rows: int, experts_hit: int, d: int, f: int,
             io_bytes: int):
    """Least time the card could take: the larger of bytes / memory rate
    (each input read once, each output written once: the three tables of
    every expert that is HIT, plus activations and indices) and operations /
    peak rate of the type (2*3*d*f per row)."""
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = (experts_hit * 3 * d * f * size + io_bytes) / HBM_BYTES_PER_S
    t_ops = (n_rows * 2 * 3 * d * f) / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def route_like_the_model(gen, T, k, n_orig, E, dev):
    """Expert ids as the serving path produces them: k DISTINCT original
    experts per token, mapped onto E stored experts by ``i % E`` (the remap
    of a freshly built merged layer), so a merged table sees duplicates."""
    scores = torch.rand((T, n_orig), generator=gen, device=dev)
    idx = scores.topk(k, dim=-1).indices
    return (idx % E).to(torch.int32)


def main_path_shapes(dev, cfg, admission_rows: int):
    """Both kernels at the shapes the serve phase gives them, full width."""
    from repro_torch.kernels import decode_moe, grouped_mlp
    from repro_torch.kernels.ref import combine_in_order
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    N, k = cfg.moe.n_experts, cfg.moe.top_k
    gen = torch.Generator(device=dev).manual_seed(7)
    checks, entries = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        size = torch.empty((), dtype=dtype).element_size()
        full = tables(gen, N, d, f, dtype, dev)
        for E in (N, N // 2):
            wg, wu, wd = [w[:E].contiguous() for w in full]
            # ---- gather: one decode step of the 8-slot engine
            T = 8
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            idx = route_like_the_model(gen, T, k, N, E, dev)
            w = torch.softmax(torch.randn((T, k), generator=gen, device=dev), -1)
            got = decode_moe.gather_swiglu(x, wg, wu, wd, idx, w)
            want = decode_moe.plain(x, wg, wu, wd, idx, w)
            err, words = compare(f"gather_swiglu[T={T},E={E},{key}]", got, want,
                                 dtype)
            # ---- the same pairs through the grouped kernel + ordered combine
            flat = idx.reshape(-1).long()
            order = torch.argsort(flat, stable=True)
            gs = torch.bincount(flat, minlength=E)
            ys = grouped_mlp.grouped_swiglu(x[order // k].contiguous(), wg, wu,
                                            wd, gs)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(T * k, device=dev)
            via_grouped = combine_in_order(ys[inv].reshape(T, k, d), w).to(dtype)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, via_grouped))
            check(bitwise, f"gather != grouped bitwise at E={E}, {key}")
            hit = int(torch.unique(flat).numel())
            io = 2 * T * d * size + T * k * 8
            b_ms, by = bound_ms(dtype, T * k, hit, d, f, io)
            ms = time_ms(lambda: decode_moe.gather_swiglu(x, wg, wu, wd, idx, w),
                         reps=20)
            p_ms = time_ms(lambda: decode_moe.plain(x, wg, wu, wd, idx, w),
                           reps=3, rounds=3)
            rec = dict(name="gather_swiglu", shape=f"T={T} k={k} E={E} d={d} "
                       f"f={f} {key}", experts_hit=hit, max_err=err, tol=words,
                       ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=p_ms,
                       bitwise_vs_grouped=bitwise)
            checks.append(rec)
            if dtype == torch.bfloat16 and E == N:
                entries["gather_swiglu"] = rec
            # ---- grouped: the largest admission of the serve phase
            Tg = admission_rows
            xg = (torch.randn((Tg // k, d), generator=gen, device=dev)
                  * 0.5).to(dtype)
            idg = route_like_the_model(gen, Tg // k, k, N, E, dev)
            flat = idg.reshape(-1).long()
            order = torch.argsort(flat, stable=True)
            xs = xg[order // k].contiguous()
            gs = torch.bincount(flat, minlength=E)
            got = grouped_mlp.grouped_swiglu(xs, wg, wu, wd, gs)
            want = grouped_mlp.plain(xs, wg, wu, wd, gs)
            err, words = compare(f"grouped_swiglu[T={Tg},E={E},{key}]", got,
                                 want, dtype)
            hit = int((gs > 0).sum())
            io = 2 * Tg * d * size + E * 4
            b_ms, by = bound_ms(dtype, Tg, hit, d, f, io)
            ms = time_ms(lambda: grouped_mlp.grouped_swiglu(xs, wg, wu, wd, gs),
                         reps=3, rounds=3)
            p_ms = time_ms(lambda: grouped_mlp.plain(xs, wg, wu, wd, gs),
                           reps=1, rounds=3)
            rec = dict(name="grouped_swiglu", shape=f"T={Tg} E={E} d={d} f={f} "
                       f"{key}", experts_hit=hit, max_err=err, tol=words, ms=ms,
                       bound_ms=b_ms, bound_by=by, plain_ms=p_ms)
            checks.append(rec)
            if dtype == torch.bfloat16 and E == N:
                entries["grouped_swiglu"] = rec
            del wg, wu, wd, xs, got, want
        del full
        gc.collect()
        torch.cuda.empty_cache()
    return checks, entries


# ---------------------------------------------------------------------------
# the trace and the engine
# ---------------------------------------------------------------------------

def make_trace(vocab: int, seed: int, n_requests: int = 16, new_tokens: int = 32):
    from repro_torch.serving import poisson_trace
    rng = np.random.default_rng(seed)
    arrivals = poisson_trace(n_requests, rate=0.5, seed=seed + 1)
    lens = rng.integers(32, 257, size=n_requests)
    return [dict(prompt=rng.integers(0, vocab, size=int(n), dtype=np.int32),
                 max_new_tokens=new_tokens, arrival_time=float(a))
            for n, a in zip(lens, arrivals)]


def engine_config(**kw):
    from repro_torch.serving import EngineConfig
    base = dict(arch=ARCH, reduced=False, n_slots=8, s_max=512,
                prefill_buckets=(64, 128, 256), decode_block=8)
    base.update(kw)
    return EngineConfig(**base)


def serve(cfg, model, trace, device, **ec_kw):
    """Drive the trace through an Engine. Returns a dict with the tokens,
    counters, the admission shapes, decode block times and kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    eng = Engine(engine_config(**ec_kw), cfg=cfg, params=model, device=device)
    admits, block_ms = [], []
    admit, multi, single = eng._admit_step, eng._decode_multi, eng._decode
    cuda = torch.device(device).type == "cuda"

    def timed(fn):
        def run(*a):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            if cuda:
                torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def admit_logged(m, c, tokens, lengths, slots):
        admits.append(tuple(tokens.shape))
        return admit(m, c, tokens, lengths, slots)

    eng._admit_step = admit_logged
    eng._decode_multi = timed(multi)
    eng._decode = timed(single)
    reqs = [eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                       arrival_time=r["arrival_time"]) for r in trace]
    ops.reset_launch_counts()            # just before the main path is driven
    t0 = time.perf_counter()
    done = eng.run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()       # just after
    check(len(done) == len(trace), "not every request came back")
    for r in reqs:
        check(r.status == "ok" and r.finish_reason == "length",
              f"request {r.uid} ended {r.status}/{r.finish_reason}")
        check(len(r.out_tokens) == r.max_new_tokens,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.uid}: token out of range")
    c = eng.counters
    check(c["host_syncs"] == len(admits) + len(block_ms),
          f"host_syncs {c['host_syncs']} != admissions {len(admits)} + "
          f"blocks {len(block_ms)}")
    return dict(tokens=[list(r.out_tokens) for r in reqs], counters=dict(c),
                admits=admits, block_ms=block_ms, wall_s=wall,
                launches=launches, n_blocks=len(block_ms),
                steps_per_block=eng.ec.decode_block)


def check_launches(res, n_layers: int, dispatch: str = "gather"):
    """gather launches == decode steps run x MoE layers; grouped launches ==
    admission calls x MoE layers (plus every decode step under ragged)."""
    steps = res["n_blocks"] * res["steps_per_block"]
    want_gather = steps * n_layers if dispatch == "gather" else 0
    want_grouped = len(res["admits"]) * n_layers + (
        steps * n_layers if dispatch == "ragged" else 0)
    got = res["launches"]
    check(got["gather_swiglu"] == want_gather,
          f"gather_swiglu launched {got['gather_swiglu']}x, expected "
          f"{want_gather}")
    check(got["grouped_swiglu"] == want_grouped,
          f"grouped_swiglu launched {got['grouped_swiglu']}x, expected "
          f"{want_grouped}")
    check(got["grouped_swiglu"] > 0, "grouped_swiglu never launched")
    if dispatch == "gather":
        check(got["gather_swiglu"] > 0, "gather_swiglu never launched")


def build_model(cfg, device, seed):
    from repro_torch.models import model as MD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MD.init(cfg, device, seed=seed)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def free():
    """Return freed tensors' memory to the card (call after ``del``)."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_summary(res, card):
    n_tok = sum(len(t) for t in res["tokens"])
    return dict(card=card, requests=len(res["tokens"]), tokens=n_tok,
                wall_s=res["wall_s"], tokens_per_s=n_tok / res["wall_s"],
                admissions=len(res["admits"]),
                largest_admission=max(res["admits"], key=lambda s: s[0] * s[1]),
                decode_blocks=res["n_blocks"],
                ms_per_decode_block_median=statistics.median(res["block_ms"]),
                ms_per_decode_block_max=max(res["block_ms"]),
                counters=res["counters"], launches=res["launches"],
                finite_lane="all ones (a zero raises NumericHealthError)")


def profile_block(cfg, model, trace, device):
    """One steady decode block (8 slots busy) under torch.profiler: host wall
    time, the device's busy share, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine
    eng = Engine(engine_config(), cfg=cfg, params=model, device=device)
    for r in trace[:8]:
        eng.submit(r["prompt"], max_new_tokens=64, arrival_time=0.0)
    eng.step_block()                                   # admission + one block
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_block()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    n_kernels = sum(e.count for e in rows if dev_us(e) > 0)
    if busy_ms == 0.0:
        return dict(wall_ms=wall_ms, device="not measured (the profiler saw "
                    "no device time)")
    return dict(wall_ms=wall_ms, steps=eng.ec.decode_block, layers=cfg.n_layers,
                device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
                device_kernels=n_kernels,
                top=[dict(name=e.key[:60], count=e.count, ms=dev_us(e) / 1e3)
                     for e in rows[:8]])


def contracts(cfg, model, device):
    """On one cache state: logits of a decode step under gather and under
    ragged dispatch, and logits of K fused steps against the same K steps
    driven one at a time, compared with torch.equal."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    gen = torch.Generator(device=device).manual_seed(3)
    B, S = 8, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    lengths = torch.randint(8, S + 1, (B,), generator=gen, device=device)

    def with_dispatch(name):
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=name, gather_max_tokens=B))

    def fresh():
        gcfg = with_dispatch("gather")
        cache = MD.init_slot_cache(gcfg, B, 128, device)
        _, k, v = MD.prefill_slots(gcfg, model, toks, lengths)
        return MD.insert_slots(cache, np.arange(B), k, v, lengths)

    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=device)
    act = torch.ones((B,), dtype=torch.bool, device=device)
    lg, _ = MD.decode_step_slots(with_dispatch("gather"), model, fresh(), tok, act)
    lr, _ = MD.decode_step_slots(with_dispatch("ragged"), model, fresh(), tok, act)
    check(bool(torch.isfinite(lg).all()), "contracts: non-finite logits")
    gather_ragged = bool(torch.equal(lg, lr))

    # a prompt prefilled alone and in a batch of four: reported, not required
    # (the projections and attention are library products whose reduction
    # order may change with the batch size)
    gcfg = with_dispatch("gather")
    alone, _, _ = MD.prefill_slots(gcfg, model, toks[:1], lengths[:1])
    among, _, _ = MD.prefill_slots(gcfg, model, toks[:4], lengths[:4])
    prefill_invariant = bool(torch.equal(alone[0], among[0]))
    prefill_gap = float((alone[0] - among[0]).abs().max())

    K = 4
    seen = []
    real = MD.decode_step_slots

    def tap(*a, **kw):
        logits, cache = real(*a, **kw)
        seen.append(logits.clone())
        return logits, cache

    rem = torch.full((B,), 100, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    MD.decode_step_slots = tap
    try:
        block, _, _ = ST.make_slot_decode_multi(gcfg, K)(model, fresh(), tok, act,
                                                         rem, eos)
        fused = list(seen)
        seen.clear()
        cache, t = fresh(), tok
        step = ST.make_slot_decode(gcfg)
        for _ in range(K):
            _, aux, cache = step(model, cache, t, act)
            t = aux[:, 0]
        stepwise = list(seen)
    finally:
        MD.decode_step_slots = real
    torch.cuda.synchronize()
    fused_step = all(torch.equal(a, b) for a, b in zip(fused, stepwise))
    check(len(fused) == K and len(stepwise) == K, "contracts: step count")
    check(bool((block[:, :, 2] == 1).all()), "contracts: finite lane")
    return dict(gather_vs_ragged_logits_bitwise=gather_ragged,
                fused_vs_stepwise_logits_bitwise=fused_step,
                prefill_alone_vs_in_batch_logits_bitwise=prefill_invariant,
                prefill_alone_vs_in_batch_max_abs_gap=prefill_gap)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24,
                    help="depth of the served model (widths are never cut); "
                         "24 is about 31 GB of bf16 weights, 48 about 61 GB")
    ap.add_argument("--variant-layers", type=int, default=4,
                    help="depth of the decode_block=1 / ragged comparison runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode block of the uncompressed model "
                         "with torch.profiler and print where its time goes")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    from repro_torch import configs, env
    from repro_torch.kernels import _build
    from repro_torch.models import numerics

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products stay fp32
    t_start = time.perf_counter()
    info = env.probe()
    emit("env", **info)
    card = info["nvidia_smi"] or info["device_name"]

    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.basename(str(p)) for p in libs],
         flags=" ".join(_build.NVCC_FLAGS))

    full_cfg = configs.get(ARCH)
    check((full_cfg.d_model, full_cfg.n_heads, full_cfg.n_kv_heads, full_cfg.hd,
           full_cfg.moe.n_experts, full_cfg.moe.top_k, full_cfg.moe.d_ff_expert,
           full_cfg.vocab_size) == (2048, 32, 4, 128, 128, 8, 768, 151936),
          "qwen3-moe-30b-a3b widths changed")

    # ---- rehearse: reduced config, card vs CPU, and the admission shapes
    small = configs.get(ARCH).reduced().replace(dtype="float32")
    trace_small = make_trace(small.vocab_size, args.seed)
    from repro_torch.models import model as MD
    cpu_model = MD.init(small, "cpu", seed=args.seed)
    gpu_model = MD.init(small, device, seed=args.seed)
    gpu_model.load_state_dict(cpu_model.state_dict())
    on_cpu = serve(small, cpu_model, trace_small, "cpu")
    on_gpu = serve(small, gpu_model, trace_small, device)
    check_launches(on_gpu, small.n_layers)
    check(on_cpu["launches"] == {"gather_swiglu": 0, "grouped_swiglu": 0},
          "the CPU path launched a kernel")
    check(on_gpu["tokens"] == on_cpu["tokens"],
          "reduced fp32 model: tokens on the card differ from the CPU's")
    check(on_gpu["admits"] == on_cpu["admits"], "admission shapes differ")
    largest = max(on_gpu["admits"], key=lambda s: s[0] * s[1])
    admission_rows = largest[0] * largest[1] * full_cfg.moe.top_k
    emit("rehearse", config=small.name, token_equal_card_vs_cpu=True,
         requests=len(trace_small), admissions=on_gpu["admits"],
         largest_admission=largest, grouped_rows_at_full_width=admission_rows,
         launches=on_gpu["launches"])
    del cpu_model, gpu_model
    free()

    # ---- kernels
    n_cases, worst = case_list(device)
    checks, entries = main_path_shapes(device, full_cfg, admission_rows)
    emit("kernels", cases_passed=n_cases, worst_abs_err_case_list=worst,
         card=card, checks=checks)

    # ---- serve: full width, bf16
    cfg = full_cfg.replace(n_layers=args.layers)
    trace = make_trace(cfg.vocab_size, args.seed)
    model, build_s = build_model(cfg, device, args.seed)
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    emit("contracts", layers=cfg.n_layers, **contracts(cfg, model, device))
    serve(cfg, model, trace[:2], device)                # warm the libraries up
    res = serve(cfg, model, trace, device)
    check_launches(res, cfg.n_layers)
    check(res["admits"] == on_gpu["admits"],
          "admission shapes differ from the rehearsal")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("serve", model=cfg.name, form="uncompressed", layers=cfg.n_layers,
         dtype=cfg.dtype, weights_gb=weights_gb, init_s=build_s,
         peak_memory_gb=peak_gb, lm_head_logits=(
             "fp32 from torch.mm(out_dtype=float32)"
             if numerics.mm_out_dtype_available()
             else "bf16 product widened to fp32"),
         **serve_summary(res, card))
    total_launches = dict(res["launches"])
    if args.profile:
        emit("profile", card=card, **profile_block(cfg, model, trace, device))
    del model
    free()

    mcfg = cfg.compressed(full_cfg.moe.n_experts // 2,
                          split=int(0.6 * cfg.n_layers))
    model, build_s = build_model(mcfg, device, args.seed)
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    serve(mcfg, model, trace[:2], device)
    res_m = serve(mcfg, model, trace, device)
    check_launches(res_m, mcfg.n_layers)
    emit("serve", model=mcfg.name, form=f"merged M={mcfg.moe_merged} on layers "
         f"[{mcfg.moe_split}, {mcfg.n_layers})", layers=mcfg.n_layers,
         dtype=mcfg.dtype, weights_gb=weights_gb, init_s=build_s,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         **serve_summary(res_m, card))
    for name in total_launches:
        total_launches[name] += res_m["launches"][name]
    del model
    free()

    # ---- variants at a small depth: decode_block=1 and dispatch="ragged"
    vcfg = full_cfg.replace(n_layers=args.variant_layers)
    model, _ = build_model(vcfg, device, args.seed)

    def tps(r):
        return sum(map(len, r["tokens"])) / r["wall_s"]

    def agree(a, b):
        flat = [x == y for ta, tb in zip(a["tokens"], b["tokens"])
                for x, y in zip(ta, tb)]
        return sum(flat) / len(flat)

    base = serve(vcfg, model, trace, device)
    check_launches(base, vcfg.n_layers)
    rag = serve(vcfg, model, trace, device, dispatch="ragged")
    check_launches(rag, vcfg.n_layers, dispatch="ragged")
    k1 = serve(vcfg, model, trace, device, decode_block=1)
    check_launches(k1, vcfg.n_layers)
    # decode_block changes WHEN requests are admitted (every step instead of
    # every 8th), hence which requests share a prefill batch; the library's
    # matrix products are not bitwise the same across batch sizes, so on the
    # staggered trace bf16 tokens may part ways. On a trace whose arrivals and
    # completions fall on block boundaries both engines admit the same groups
    # at the same steps, and there the tokens must be identical.
    aligned = [dict(r, arrival_time=float(np.ceil(r["arrival_time"] / 8) * 8),
                    max_new_tokens=33) for r in trace]
    base_a = serve(vcfg, model, aligned, device)
    k1_a = serve(vcfg, model, aligned, device, decode_block=1)
    check(base_a["admits"] == k1_a["admits"],
          "block-aligned trace: admission groups differ between K=8 and K=1")
    variants = dict(
        layers=vcfg.n_layers, base_tokens_per_s=tps(base),
        dispatch_ragged=dict(token_equal=rag["tokens"] == base["tokens"],
                             tokens_per_s=tps(rag)),
        decode_block_1_same_admission_groups=dict(
            token_equal=k1_a["tokens"] == base_a["tokens"],
            tokens_per_s=tps(k1_a), base_tokens_per_s=tps(base_a)),
        decode_block_1_staggered=dict(
            token_equal=k1["tokens"] == base["tokens"],
            same_admission_groups=k1["admits"] == base["admits"],
            share_of_tokens_equal=agree(k1, base), tokens_per_s=tps(k1)))
    emit("serve", form="variants", card=card, **variants)
    check(variants["dispatch_ragged"]["token_equal"],
          "dispatch='ragged' gives other tokens than dispatch='gather'")
    check(variants["decode_block_1_same_admission_groups"]["token_equal"],
          "decode_block=1 gives other tokens than decode_block=8 although "
          "both admitted the same groups at the same steps")
    del model
    free()

    # ---- the record
    kernels = []
    for name, meta in TABLE.items():
        rec = entries[name]
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=total_launches[name],
            max_abs_err=rec["max_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=None, shape=rec["shape"]))
        check(total_launches[name] > 0, f"{name} never launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"elapsed_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(env.gpu_line() or torch.cuda.get_device_name(0), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
