#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                 # one NVIDIA GPU (sm_90), ~31 GB of weights
    python3 chip_smoke.py --layers 48     # the full depth of qwen3-moe-30b-a3b, ~61 GB

Needs CUDA and ``nvcc``; exits non-zero without them. Phases, each printing
one JSON line:

  env       what it runs on (repro_torch.env.probe)
  build     compiles the eight CUDA kernels from src/repro_torch/kernels/csrc
  rehearse  the serve trace on the reduced fp32 configs: the engine on the card
            (CUDA kernels) against the same engine on the CPU (plain PyTorch),
            token for token, in every served form: qwen3-moe's dense
            bf16-layout cache, paged pool (and paged == dense on the card),
            paged int8 pool, int8 expert tables; granite-8b's dense cache,
            paged pool and paged int8 pool; both configs sampled at
            temperature 0.7; and the admission shapes the trace produces
  kernels   each kernel against its plain PyTorch version on the card: the case
            lists of tests/test_torch_kernels*.py, test_torch_paged_attention.py
            and the reference's swiglu cases (tests/test_kernels.py; odd
            widths, T = 1, zero weights giving exactly 0)
            (duplicate and out-of-range ids, zero-sized groups, live-masked pad
            rows, NaN in blocks a slot does not own, lens == 0, a contiguous
            table against the dense attention), then the serve phase's shapes at
            full width, timed; int8 gather == int8 grouped bitwise; quantizing
            one full-width layer on the card == on the CPU, bitwise. The paged
            kernels are held to half an output ulp against the plain version
            at fp32, on a peaked softmax, and that tolerance must reject the
            plain version with each slot's last row dropped; their split plan
            (a function of the table's shape only) on both kernels and both
            pool types: lens on every table-entry (so every split) boundary,
            1 and the whole table, lens 0 giving zeros, NaN in unowned blocks
            and past lens moving nothing, a slot alone == among 8 == among
            64, a table padded with sentinels to twice its length and the
            dense cache's contiguous table == the paged table, all bitwise;
            both timed at qwen3-moe's and granite-8b's heads; flash_attention
            likewise (plus the rounding of p to the input type), with its
            last visible key dropped, over causal / non-causal, Sq < Sk, odd
            lengths, GQA, query offsets and hd 80 and 96, and its rows are
            bitwise the same alone, in a batch, in a longer prefill and
            behind an offset (hd 64 and 80); timed
            at the admission and the capture shape and zamba2's prefill
            (hd 80) beside one library call
            (CUDA events around back-to-back calls, and the device time of
            calls replayed from a CUDA graph);
            swiglu_mlp at widths past granite's f (yi-34b, qwen1.5-110b) and
            kimi-k2's shared expert, a row alone == among 8, 64 and 256
            bitwise (with and without round_gu, the model's rounding of g
            and u, which is also held bitwise to the plain version on inputs
            whose sums are exact), timed at granite's decode and admission
            shapes beside
            the cuBLAS composition the model's MLP ran before it. Four
            kernels route: flash_attention and swiglu_mlp by dtype, bf16 to
            their tensor-core kernels, fp32 to the CUDA-core ones (each route
            held to the plain version and timed; in fp32 swiglu_mlp ==
            grouped_swiglu with one group, bitwise); shapes the tensor-core
            kernels do not take (d or f not a multiple of 8, hd not a
            multiple of 8, hd above 256) are refused before launch.
            gather_swiglu and grouped_swiglu by dtype and width: bf16 at
            widths that are multiples of 8 to their tensor-core kernels
            (held to the plain version at bf16 and at fp32, a row bitwise the
            same alone, among 8, 64 and 2048 and in a segment of 1 or 100,
            timed beside their CUDA-core kernels), anything else to the
            CUDA-core ones; the int8 pair gather_swiglu_q / grouped_swiglu_q
            likewise at widths that are multiples of 16 (the int8 contract:
            scales after the sums, h as bf16 hi + lo; two bf16 ulps of
            max|y| against the plain version, the same checks, its combine
            bitwise combine_in_order on both routes; summed over the
            outputs, nearer the plain version than the plain arithmetic
            with h rounded once to bf16, so h's lo half is used). The
            threefry bits
            and uniforms on the card == on the CPU, the Gumbel noise to 2
            ulps of max(|g|, 1)
  contracts gather == ragged and fused-K == step-at-a-time on logits, bitwise
            (and on the engine's CUDA graphs: tokens and cache); a
            prompt admitted alone and in a group of four gives bitwise-equal
            logits (each row replayed from its pad shape's graph, as the
            engine admits; and what that costs per admission group, eager
            and on the graphs); paged == dense
            on admission and decode logits, bitwise (dense decode runs the
            paged kernel over a contiguous table), and a prefix hit (its
            suffix padded to the whole prompt's bucket) == the whole
            admission, bitwise (read beside it: the suffix at its own bucket,
            the ms of each, which products see the row count); the dense
            decode block against the
            previous plain attention over the whole cache, in 10 alternating
            pairs; int8 gather == int8 ragged
  serve     qwen3-moe-30b-a3b at full width (depth cut to --layers), bf16,
            random weights from a seed, 16 requests on a Poisson trace (4 of
            them share a 128-token prefix) through the continuous-batching
            engine, which on the card replays every decode block and every
            admitted prompt from a CUDA graph (checked: replays == blocks and
            admitted rows; the graphs' capture and instantiate seconds and
            pool bytes reported): uncompressed with the dense cache, the
            paged pool (prefix hits checked) and the paged int8 pool, then
            int8 expert tables;
            merged (M = N/2 on the suffix) in bf16 and in int8. Teacher-forced
            top-1 agreement of each form with the dense bf16 engine, at the
            served batch (the dense engine's own stream must read 1.0, and so
            must the paged bf16 pool, whose served tokens equal dense's; paged
            int8 KV must reach 0.95 at the reduced config). Then the same
            trace with decode_block=1 (token equal to decode_block=8) and
            dispatch="ragged" at --variant-layers. With --profile, one
            decode block each of the bf16-table and the int8-table model under
            torch.profiler, the int8 one also with its MoE pair held to the
            CUDA-core route (the route before the tensor-core one); each
            profile reports the paged attention kernels' share, and is taken
            twice: the block replayed from its graph and run eagerly
  spec      speculative decoding (SPEC_K = 4 proposals a round, each round
            one replay of the engine's "spec round" graph, each admitted
            prompt one replay of each model's admission graph): at the serve
            phase's depth, the model as its own draft (acceptance exactly
            1.0) and a random 2-layer draft at the same widths (acceptance
            near 0), both token for token the plain dense engine; verify
            over [t0, d_1..d_4] == five decode steps, bitwise, on logits and
            every K/V row, dense cache, paged bf16 and int8 pools, the
            verify's paged kernel (40 query rows, per-row lens) and grouped
            kernel held to their plain versions; a verify's device ms beside
            a decode step's; a reading: which glue operation gives a row
            other bits at 8 decode rows against their verify's 40, and at 64
            against 320. In the compress phase, the MergeMoE model drafts
            for the model it was merged from (dense cache greedy and at
            temperature 0.7, paged bf16 with prefix hits, paged int8), tokens
            equal to the plain engine's in each form, and the round on its
            graph == eager (both caches after every step, every call's
            outputs) in the dense and the paged int8 form. Launch counts
            exact; acceptance, rounds, ms per round, tokens/s beside plain
  graphs    in every serve form of both families (and the single step of
            decode_block=1), an engine replaying its graphs and one running
            the same bodies eagerly, in lockstep on 16 requests: every
            call's outputs (admission logits and first tokens at each pad
            shape, each block or step) and the whole cache after every
            engine step (pos, KV rows, pool blocks but the write-only sink,
            the table), bitwise; then eager against graph in 10 alternating
            pairs, ms per decode block and per admitted prompt of 64, 128
            and 256 tokens (qwen3-moe with bf16 and int8 tables, granite-8b
            with the dense cache and the paged int8 pool)
  dense     granite-8b at its published widths and full depth (36 layers),
            bf16, random weights: the contracts (fused K == stepwise and a
            prompt alone == in a group of four on logits, paged == dense on
            admission and decode logits, bitwise; decode_block=8 == 1 token
            for token at temperature 0.7; layer 0's MLP on the card with
            round_gu closer to the CPU's model arithmetic, bitwise share of
            outputs, than the kernel contract) and, a reading, the logit gap
            of the model's MLP on the card (round_gu) and of the kernel
            contract against the cuBLAS MLP it replaced, for two sets of
            inputs; then the trace served with
            the dense cache, the paged pool (prefix hits) and the paged int8
            pool, greedy, and the dense cache at temperature 0.7 (with
            --profile, one decode block of the dense cache and one of the
            paged int8 pool under torch.profiler)
  families  the fixed-batch server (launch.serve.FixedBatchServer, the
            non-slot model API, its prefill and each step replayed from
            CUDA graphs) over every family: each ARCH_IDS
            config reduced in fp32 on the card against the same server on
            the CPU, token for token, with the reference's decode == forward
            contract on the card (its shape and tolerance); then
            mamba2-370m, zamba2-2.7b (flash at hd 80 on the tensor cores),
            whisper-base (1500 random frames, 32-token prompts) and
            phi-3-vision-4.2b (64 patches) and granite-8b at their
            published widths and full depth, bf16, random weights, batch 4,
            128-token prompts, 32 new tokens: every kernel launch counted
            against the path's and on the tensor-core routes, the same
            tokens twice, ms per prefill and per step, tokens/s, peak
            memory, decode == forward (a reading); granite-8b's server ==
            its engine token for token; each of the five on its graphs
            against the same bodies run eagerly, bitwise (the prefill's
            and every step's logits, the tokens, greedy and at
            temperature 0.7), one step replay crediting exactly an eager
            step's launches by kernel and route, ms a step and a prefill
            eager against graph in alternating pairs, the graphs' capture
            and instantiate seconds and pool bytes (with --profile, one
            replayed step under torch.profiler). In the serve phase, a
            reading:
            qwen3-moe at --layers through the server against the engine
            (C5)
  train     the trainer (launch.train.train, the reference's training
            arithmetic: no hand-written kernel, each block under the
            config's remat): reduced qwen3-moe and granite-8b in fp32, 5
            AdamW steps on the card against the same 5 on the CPU (losses
            and every parameter within REHEARSE_LOSS_RTOL /
            REHEARSE_PARAM_ATOL); the resume drill on the card under
            torch.use_deterministic_algorithms(True) (RESUME_K steps, the
            trainer's checkpoint to a temporary directory, a fresh trainer,
            RESUME_K more, against 2 * RESUME_K straight: bitwise or the
            differing leaves named with their gaps); the other four
            families (mamba2, zamba2 at 4 layers, whisper with seeded
            frames, phi-3-vision with seeded patches) reduced in fp32
            through the train step, each of 5 AdamW steps on the card from
            the CPU's state against the CPU's step, and the straight runs
            as a reading; then mamba2-370m, zamba2-2.7b, whisper-base
            (1500 frames) and phi-3-vision-4.2b (64 patches) at their
            published widths and depth, bf16, their remat, AdamW,
            gradients in bf16, TRAIN_FAMILY_STEPS steps at TRAIN_BATCH x
            TRAIN_SEQ: every loss finite, the last TRAIN_LOSS_DROP below
            the first, no hand-written kernel launched; ms per step,
            tokens/s, peak memory; then qwen3-moe-30b-a3b
            at its published widths, COMPRESS_LAYERS layers, bf16, remat
            "full", capacity dispatch, AdamW, gradients in bf16,
            TRAIN_STEPS steps of SyntheticLM(seed) at TRAIN_BATCH x
            TRAIN_SEQ: every loss finite, the last TRAIN_LOSS_DROP below
            the first, no hand-written kernel launched; ms per step, tokens/s,
            peak memory. Its model goes on to the compress phase
  compress  MergeMoE on the train phase's model (qwen3-moe-30b-a3b at full
            width, depth cut to 4 layers, COMPRESS_LAYERS), trained: the
            held-out loss of both models on a SyntheticLM batch beside the
            uniform-token one, and C4, the paged int8 pool's teacher-forced
            top-1 against the bf16 engine (a reading). Calibration captured on the card through the
            model's forward with the config's own capacity dispatch (the
            flash kernel in every layer), the suffix merged 128 -> 64 in fp64
            on the host, held-out loss of both models; MergeMoE's in-sample
            output error on a merged layer at most M-SMoE's; the compressed
            model served in bf16, drafting for the full model (the spec
            line) and with int8 tables
  ckpt      inside the compress phase: the compression entry point writes
            the bf16 artifact (launch.compress.run(save_dir=)), which
            Engine.from_checkpoint loads torch.equal to the in-memory model
            and serves token for token as it; the full model served with
            EngineConfig(spec_draft=<the artifact>), tokens equal to the
            plain engine's and acceptance to the in-process draft's; then the
            int8-table model saved, loaded and served the same way. Bytes on
            disk, seconds to save and to load (digest included), GB/s. The
            artifacts go to a temporary directory (its free space checked
            first), one at a time, each deleted after its checks
  resilience after the variants, at their depth (--variant-layers) and the
            published widths, on the engine's CUDA graphs, in three forms:
            the paged bf16 pool, the paged int8 pool, and speculative rounds
            with the model as its own draft on the dense cache. In each: a
            seeded nan_logits plan on a decoding slot quarantines that
            request (failed_numeric, a prefix of its clean tokens) while
            every other request's tokens are the clean run's, with each
            graph captured once (the poison mask is a static buffer); a
            transient plan on every decode and admission call within
            device_retries gives the clean tokens, one beyond it raises
            DeviceStepError; snapshot() mid-trace restored into a fresh
            engine finishes token for token (its cache tensors never
            rebound), as do the engine that kept running and the snapshot
            loaded back into it (no graph captured again). The paged bf16
            snapshot also goes through the disk: save_snapshot to a
            temporary directory (free space checked first, deleted after),
            loaded with its digest verified and finished token for token,
            and refused once FaultPlan.corrupt flips a leaf. A snapshot of
            the reduced fp32 config taken on the card finishes on the CPU
            and one taken on the CPU finishes on the card, token for token
            as the CPU's uninterrupted run. Then the hard-kill drill: the
            child tests/_torch_snapshot_drill_child.py serves on the card
            with periodic snapshots and leaves with os._exit; restored here,
            its finished requests and the rest equal an uninterrupted run,
            none lost. Snapshot bytes and the seconds to snapshot, save,
            load and restore, beside the card's name and power limit
  witness   (--witness-layers N only) the paged int8 pool's top-1 against the
            bf16 pool at full width and depth N, on the card and on the CPU's
            plain path, same weights and contexts

then a ``{"kernels": [...]}`` line (times, bounds and the main path's launch
counts, by route too: the bf16 main path must launch only the tensor-core
kernels of flash_attention, swiglu_mlp and the two MoE pairs),
the card's name and power limit,
and ``{"ok": true, ...}`` last. Any
failing check raises: nothing is caught and no kernel failure is answered by
the plain version.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
#: the dense-family model, served at its published widths and full depth
DENSE = "granite-8b"
#: the sampled forms' temperature
TEMPERATURE = 0.7
#: published peaks of one H100 SXM (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KV_BLOCK = 16
#: teacher-forced top-1 floor of the paged int8 pool against the dense bf16
#: engine (the reference's own gate, benchmarks/serve_bench.py)
KV_INT8_TOLERANCE = 0.95
#: the compress phase: depth cut to 4 layers so that two host solves fit the
#: run, layers [2, 4) merged 128 -> 64; calibration 2 batches x 4 x 160 =
#: 1280 tokens (> f = 768, so the least squares are determined); 1 held-out
#: batch of the same shape; 8 requests of the serve trace on the merged model
COMPRESS_LAYERS, COMPRESS_SPLIT = 4, 2
CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ = 2, 4, 160
EVAL_BATCHES, COMPRESS_REQUESTS = 1, 8
CSRC = "src/repro_torch/kernels/csrc/"
TABLE = {
    "gather_swiglu": dict(source=CSRC + "gather_swiglu.cu",
                          replaces="src/repro/kernels/decode_moe.py:56"),
    "grouped_swiglu": dict(source=CSRC + "grouped_swiglu.cu",
                           replaces="src/repro/kernels/grouped_mlp.py:103"),
    "gather_swiglu_q": dict(source=CSRC + "gather_swiglu_q.cu",
                            replaces="src/repro/kernels/decode_moe.py:118"),
    "grouped_swiglu_q": dict(source=CSRC + "grouped_swiglu_q.cu",
                             replaces="src/repro/kernels/grouped_mlp.py:148"),
    "paged_attention": dict(source=CSRC + "paged_attention.cu",
                            replaces="src/repro/kernels/paged_attention.py:124"),
    "paged_attention_q": dict(
        source=CSRC + "paged_attention_q.cu",
        replaces="src/repro/kernels/paged_attention.py:152"),
    "flash_attention": dict(source=CSRC + "flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:77"),
    "swiglu_mlp": dict(source=CSRC + "swiglu_mlp.cu",
                       replaces="src/repro/kernels/swiglu.py:49"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dtype_key(dtype) -> str:
    return str(dtype).split(".")[-1]


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


def attn_tol_for(dtype, want: torch.Tensor, vmax: float):
    """Paged attention against its plain version run on the same inputs
    widened to fp32 (exactly), so that neither rounds anything before the
    output: the kernel keeps K/V rows, logits, softmax and accumulator in
    fp32. fp32: the order of the fp32 sums and of the online softmax's
    rescaling differs. bf16 adds the kernel's one rounding of the output,
    half an ulp: at most 2^-8 of |y| per element."""
    scale = max(float(want.float().abs().max()), 1e-6) if want.numel() else 1.0
    atol = 1e-5 * vmax + 2e-5 * scale
    if dtype == torch.float32:
        return (1e-4, atol,
                "rtol 1e-4, atol 1e-5*max|v| + 2e-5*max|y| (fp32 sum order)")
    return (2.0 ** -8 + 1e-4, atol,
            "vs the plain version at fp32: rtol 2^-8 (the output's rounding "
            "to bf16) + 1e-4, atol 1e-5*max|v| + 2e-5*max|y| (fp32 sum "
            "order)")


def compare(name, got, want, dtype, tol=None):
    torch.cuda.synchronize()
    rtol, atol, words = tol if tol is not None else tol_for(dtype, want)
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


GROUPED_CASES = {
    "empty-middle": [10, 0, 37, 17], "single-expert": [64],
    "tiny-and-dominant": [1, 1, 1, 1, 60], "block-aligned": [16, 16, 16, 16],
    "empty-first": [0, 10], "empty-last": [10, 0],
    "leading-empties": [0, 0, 16], "trailing-empties": [5, 0, 0, 0],
    "empty-run-middle": [3, 0, 0, 3], "all-but-one-empty": [0, 0, 0, 0, 64],
    "post-merge": [40, 0, 24, 0, 16, 0, 8, 0], "T-zero": [0, 0, 0, 0],
    "odd-widths": [3, 0, 9],
}
GATHER_CASES = {
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
#: (T, d, f): the reference's swiglu cases (tests/test_kernels.py: its shape
#: list and property test), T = 1, T not a multiple of the kernel's 8-row
#: block, odd widths, a reduction axis longer than one staged chunk of 1024
#: (d, then f, with a partial last chunk), T = 0, and widths of 8 times an odd
#: number (ragged column and reduction tiles of the tensor-core route). The
#: tensor-core route takes d and f multiples of 8: in bf16 a case with other
#: widths must be refused before launch and runs at its widths rounded up.
SWIGLU_CASES = {
    "ref-32x16x32": (32, 16, 32), "ref-64x32x48": (64, 32, 48),
    "ref-128x64x64": (128, 64, 64), "ref-48x24x96": (48, 24, 96),
    "property-40x8x48": (40, 8, 48), "property-16x24x16": (16, 24, 16),
    "T-one": (1, 16, 32), "T-13": (13, 24, 40), "odd-widths": (7, 23, 31),
    "d-chunks": (9, 2500, 40), "f-chunks": (5, 16, 2100), "T-zero": (0, 16, 32),
    "ragged-8-odd": (11, 8 * 45, 8 * 131),
    "phi3v-3072x8192": (4, 3072, 8192), "zamba2-2560x10240": (4, 2560, 10240),
    "whisper-512x2048": (4, 512, 2048),
}
#: (B, nq, nkv, hd, bs, mb) as in tests/test_torch_paged_attention.py
PAGED_CASES = {"mha": (2, 4, 4, 16, 4, 3), "gqa4": (3, 8, 2, 16, 8, 2),
               "hd32": (1, 4, 4, 32, 4, 4), "serve-like": (4, 8, 1, 128, 16, 4),
               "long-table": (2, 8, 2, 64, 16, 40),
               "mha-hd80": (4, 32, 32, 80, 16, 10),
               "mha-hd96": (4, 32, 32, 96, 16, 14),
               "mha-whisper": (4, 8, 8, 64, 16, 5)}


def up_to(n: int, m: int) -> int:
    return -(-n // m) * m


def check_refused(fn, what: str) -> None:
    """``fn`` raises ValueError before any kernel launches: a shape the
    kernel does not take."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    try:
        fn()
    except ValueError:
        check(ops.launch_counts() == before, f"{what}: launched, then refused")
        return
    raise AssertionError(f"{what}: a shape the kernel does not take ran")


def paged_inputs(gen, B, nq, nkv, hd, nb, bs, mb, dtype, dev, lens=None):
    """Random pools and a valid table: slot b owns ceil(lens[b]/bs) distinct
    blocks, the rest of its row is the sentinel ``nb``. q is 8x the scale of
    k, so the logits have a standard deviation of 2 and the softmax is
    peaked: a wrong mask or scale moves the output by far more than the
    tolerance."""
    q = (torch.randn((B, nq, hd), generator=gen, device=dev) * 4.0).to(dtype)
    kp = (torch.randn((nb, bs, nkv, hd), generator=gen, device=dev)
          * 0.5).to(dtype)
    vp = (torch.randn((nb, bs, nkv, hd), generator=gen, device=dev)
          * 0.5).to(dtype)
    if lens is None:
        lens = torch.randint(1, mb * bs + 1, (B,), generator=gen, device=dev)
    lens = lens.to(torch.int32)
    tab = torch.full((B, mb), nb, dtype=torch.int32)
    perm = torch.randperm(nb, generator=gen, device=dev).cpu()
    used = 0
    for b, n in enumerate(lens.tolist()):
        need = -(-n // bs)
        tab[b, :need] = perm[used:used + need]
        used += need
    check(used <= nb, "paged inputs: pool too small")
    return q, kp, vp, tab.to(dev), lens


def paged_pair(q, kp, vp, tab, lens, int8):
    """(kernel, plain at fp32, plain in the input type, max|v|, plain at fp32
    as a function of lens) of one paged attention call. The fp32 plain
    version takes the same inputs widened to fp32 (int8 pools: dequantized
    to fp32), which is exact."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import ops, paged_attention as PA
    q32 = q.float()
    if not int8:
        plain = ops.KERNELS["paged_attention"].plain
        k32, v32 = kp.float(), vp.float()

        def want(ln):
            return plain(q32, k32, v32, tab, ln)
        return (PA.paged_attention(q, kp, vp, tab, lens), want(lens),
                plain(q, kp, vp, tab, lens), float(v32.abs().max()), want)
    plain = ops.KERNELS["paged_attention_q"].plain
    kq, ks = Q.quantize_kv(kp)
    vq, vs = Q.quantize_kv(vp)

    def want(ln):
        return plain(q32, kq, vq, ks, vs, tab, ln)
    return (PA.paged_attention_q(q, kq, vq, ks, vs, tab, lens), want(lens),
            plain(q, kq, vq, ks, vs, tab, lens),
            float((vs.abs().max() * 127).item()), want)


def check_sees_dropped_row(name, want_of, lens, dtype, vmax):
    """The tolerance of a paged kernel's check must reject the plain version
    with the last valid row of every slot dropped (lens - 1): the fault it is
    there to catch."""
    want = want_of(lens)
    off = want_of((lens - 1).clamp(min=0))
    rtol, atol, _ = attn_tol_for(dtype, want, vmax)
    torch.cuda.synchronize()
    check(not bool(torch.allclose(off.float(), want.float(), rtol=rtol,
                                  atol=atol)),
          f"{name}: the tolerance cannot tell a dropped last row")


def paged_pools(int8, kp, vp):
    """(kp, vp, ks, vs) of one pool type: as given, scales None, or (int8)
    quantized here."""
    from repro_torch.core import quant as Q
    if not int8:
        return kp, vp, None, None
    kq, ks = Q.quantize_kv(kp)
    vq, vs = Q.quantize_kv(vp)
    return kq, vq, ks, vs


def paged_run(q, pools, tab, lens):
    """The paged kernel of the pools' type (int8 when they carry scales)."""
    from repro_torch.kernels import paged_attention as PA
    kp, vp, ks, vs = pools
    if ks is None:
        return PA.paged_attention(q, kp, vp, tab, lens)
    return PA.paged_attention_q(q, kp, vp, ks, vs, tab, lens)


def paged_split_checks(gen, dev, dtype, note) -> int:
    """The split plan of both paged kernels (a function of (mb, bs) only) on
    the card, in one pool type each (bf16 / fp32 pools, int8 pools):
    - lens on every table-entry boundary (k bs - 1, k bs, k bs + 1: every
      split holds whole entries, so these include every split boundary),
      lens 1 and the whole table, held to the plain version at fp32 under
      ``attn_tol_for``, which must reject the plain version with each slot's
      last row dropped;
    - lens 0 gives finite zeros and leaves the other slots' bits;
    - NaN in every block a slot does not own and in its rows past lens (int8
      pools: NaN scales) moves no output bit;
    - bitwise: a slot alone == among 8 == among 64; its table padded with
      sentinels to 2 mb == unpadded; the dense cache's contiguous table ==
      the paged table over the same rows.
    Returns the number of checks."""
    key = dtype_key(dtype)
    n = 0
    nq, nkv, hd, bs, mb = 8, 2, 128, 16, 16
    bounds = sorted({x for k in range(1, mb + 1)
                     for x in (k * bs - 1, k * bs, k * bs + 1)
                     if 0 < x <= mb * bs} | {1, mb * bs})
    B = 64
    lens = torch.tensor((bounds * 2)[:B], dtype=torch.int32, device=dev)
    q, kp, vp, tab, lens = paged_inputs(gen, B, nq, nkv, hd, B * mb + 1, bs,
                                        mb, dtype, dev, lens=lens)
    nb = kp.shape[0]
    for int8 in (False, True):
        kname = "paged_attention_q" if int8 else "paged_attention"
        tag = f"{kname}[split plan,{key}]"
        got, want, _, vmax, want_of = paged_pair(q, kp, vp, tab, lens, int8)
        err, _ = compare(f"{tag} boundary lens", got, want, dtype,
                         attn_tol_for(dtype, want, vmax))
        check_sees_dropped_row(f"{tag} boundary lens", want_of, lens, dtype,
                               vmax)
        note(kname, err)
        pools = paged_pools(int8, kp, vp)

        def call(q, tab, lens, pools=pools):
            return paged_run(q, pools, tab, lens)
        ref = call(q, tab, lens)
        among8 = call(q[:8].contiguous(), tab[:8].contiguous(),
                      lens[:8].contiguous())
        alone = [call(q[b:b + 1].contiguous(), tab[b:b + 1].contiguous(),
                      lens[b:b + 1].contiguous()) for b in range(0, B, 7)]
        padded = call(q, torch.cat([tab, torch.full_like(tab, nb)],
                                   1).contiguous(), lens)
        lens0 = lens.clone()
        lens0[::5] = 0
        y0 = call(q, tab, lens0)
        torch.cuda.synchronize()
        check(torch.equal(among8, ref[:8]), f"{tag}: 8 slots != 64 slots")
        check(all(torch.equal(a[0], ref[b])
                  for a, b in zip(alone, range(0, B, 7))),
              f"{tag}: a slot alone != among 64")
        check(torch.equal(padded, ref),
              f"{tag}: the table padded to 2 mb != unpadded")
        check(bool(torch.isfinite(y0).all()) and bool((y0[::5] == 0).all())
              and all(torch.equal(y0[b], ref[b]) for b in range(B)
                      if b % 5),
              f"{tag}: lens 0 is not finite zeros beside unmoved slots")
        # poison: every block no slot owns, and the rows past each slot's
        # lens in its last block (int8: their scales)
        owned = set(tab.reshape(-1).tolist()) - {nb}
        poisoned = [t.clone() if t is not None else None for t in pools]
        idx = 2 if int8 else 0
        for blk in range(nb):
            if blk not in owned:
                poisoned[idx][blk] = float("nan")
                poisoned[idx + 1][blk] = float("nan")
        for b in range(B):
            last = int(tab[b, (int(lens[b]) - 1) // bs])
            poisoned[idx][last, (int(lens[b]) - 1) % bs + 1:] = float("nan")
            poisoned[idx + 1][last, (int(lens[b]) - 1) % bs + 1:] = \
                float("nan")
        moved = paged_run(q, poisoned, tab, lens)
        # the dense cache's layout: slot b's rows in blocks b mb .. b mb +
        # mb - 1 of a pool of B mb blocks, read through a contiguous table
        order = tab.long().clamp(max=nb - 1).reshape(-1)
        dense = [t[order].contiguous() if t is not None else None
                 for t in pools]
        tabc = torch.arange(B * mb, dtype=torch.int32,
                            device=dev).reshape(B, mb)
        via_dense = paged_run(q, dense, tabc, lens)
        torch.cuda.synchronize()
        check(torch.equal(moved, ref),
              f"{tag}: NaN in unowned blocks / rows past lens moved the output")
        check(torch.equal(via_dense, ref),
              f"{tag}: the contiguous (dense cache) table != the paged table")
        n += 7
    return n


#: (B, H, nkv, Sq, Sk, hd, causal, qoff) as the reference's flash case list
#: (tests/test_kernels.py) at reduced widths, plus GQA, odd lengths, Sq < Sk
#: and Sq > Sk causal (rows that see no key), query offsets (the
#: prefix-sharing admission), the model's head width and the families'
#: shapes: zamba2's and phi-3-vision's heads, whisper-base's encoder (1500
#: frames, 23 key tiles and a tail, non-causal) and its cross-attention (32
#: prompt rows at prefill, one row at decode, over the 1500 frames). The
#: tensor-core route takes hd multiples of 8: in bf16 a case with another
#: hd must be refused before launch and runs at its hd rounded up.
FLASH_CASES = {
    "mha-32": (1, 1, 1, 32, 32, 8, True, None),
    "gqa-64": (2, 4, 2, 64, 64, 16, True, None),
    "noncausal-128": (1, 2, 2, 128, 128, 32, False, None),
    "odd-97": (2, 2, 1, 97, 97, 16, True, None),
    "rect-causal": (1, 4, 2, 24, 100, 64, True, None),
    "rect-cross": (1, 2, 2, 32, 64, 16, False, None),
    "no-key-rows": (1, 2, 1, 70, 40, 16, True, None),
    "query-offsets": (2, 4, 2, 40, 160, 32, True, (0, 77)),
    "hd128-odd": (1, 8, 1, 130, 130, 128, True, None),
    "hd80-zamba2": (2, 32, 32, 128, 128, 80, True, None),
    "hd96-phi3v": (2, 8, 8, 192, 192, 96, True, None),
    "hd24-zero-tail": (1, 4, 2, 50, 50, 24, True, None),
    "whisper-encoder": (4, 8, 8, 1500, 1500, 64, False, None),
    "whisper-cross-prefill": (4, 8, 8, 32, 1500, 64, False, None),
    "whisper-cross-decode": (4, 8, 8, 1, 1500, 64, False, None),
    "hd12-not-8": (1, 2, 1, 33, 33, 12, True, None),
}


def flash_tol_for(dtype, want: torch.Tensor, vmax: float):
    """flash_attention against its plain version run on the same inputs
    widened to fp32 (exactly). The kernel keeps logits, softmax and
    accumulator in fp32 but, as the TPU kernel does, rounds p to the input
    type before the value product: each p moves by at most 2^-8 of itself in
    bf16, the output by at most 2^-8 max|v|. Then the output's one rounding,
    half an ulp: 2^-8 of |y|."""
    scale = max(float(want.float().abs().max()), 1e-6) if want.numel() else 1.0
    if dtype == torch.float32:
        return (1e-4, 1e-5 * vmax + 2e-5 * scale,
                "rtol 1e-4, atol 1e-5*max|v| + 2e-5*max|y| (fp32 sum order)")
    return (2.0 ** -8 + 1e-4, (2.0 ** -8 + 1e-5) * vmax + 2e-5 * scale,
            "vs the plain version at fp32: rtol 2^-8 (the output's rounding "
            "to bf16) + 1e-4, atol 2^-8*max|v| (p rounded to bf16 before the "
            "value product) + 1e-5*max|v| + 2e-5*max|y| (fp32 sum order)")


def flash_inputs(gen, B, H, nkv, Sq, Sk, hd, dtype, dev):
    """q [B, H, Sq, hd] at 8x the scale of k [B, nkv, Sk, hd] (peaked
    softmax, as paged_inputs), v like k."""
    q = (torch.randn((B, H, Sq, hd), generator=gen, device=dev) * 4.0).to(dtype)
    k = (torch.randn((B, nkv, Sk, hd), generator=gen, device=dev)
         * 0.5).to(dtype)
    v = (torch.randn((B, nkv, Sk, hd), generator=gen, device=dev)
         * 0.5).to(dtype)
    return q, k, v


def flash_plain32(q, k, v, causal, qoff=None, drop: int = 0):
    """The plain version on the inputs widened to fp32 (exact), GQA
    expanded. With query offsets, batch row b over its first ``qoff[b] +
    Sq`` keys (the plain version's bottom-right alignment then puts query
    row i at key position ``qoff[b] + i``). ``drop``: that many of each
    row's last visible keys left out, the fault the tolerance must see."""
    from repro_torch.kernels import ops
    plain = ops.KERNELS["flash_attention"].plain
    n_rep = q.shape[1] // k.shape[1]
    q32 = q.float()
    k32 = k.float().repeat_interleave(n_rep, dim=1)
    v32 = v.float().repeat_interleave(n_rep, dim=1)
    Sq, Sk = q.shape[2], k.shape[2]
    if qoff is None:
        return plain(q32, k32[:, :, :Sk - drop], v32[:, :, :Sk - drop],
                     causal=causal)
    return torch.cat([plain(q32[b:b + 1], k32[b:b + 1, :, :o + Sq - drop],
                            v32[b:b + 1, :, :o + Sq - drop], causal=True)
                      for b, o in enumerate(qoff.tolist())])


#: keys per staged tile in both of the kernel's routes (csrc ``kBK``)
FLASH_KEY_TILE = 64


def check_flash(name, got, q, k, v, causal, dtype, qoff=None):
    """The kernel's output against the fp32 plain version, and the
    tolerance's power to see dropped keys: the last one, or over 1024 keys
    or more, where one key weighs about 1/Sk and sits under bf16's
    tolerance, the last tile's ragged tail (28 rows at 1500 keys; a whole
    tile if Sk is a multiple of it). Returns the max abs error."""
    want = flash_plain32(q, k, v, causal, qoff)
    vmax = float(v.float().abs().max())
    tol = flash_tol_for(dtype, want, vmax)
    err, _ = compare(name, got, want, dtype, tol)
    Sk = k.shape[2]
    drop = 1 if Sk < 1024 else (Sk % FLASH_KEY_TILE or FLASH_KEY_TILE)
    off = flash_plain32(q, k, v, causal, qoff, drop=drop)
    torch.cuda.synchronize()
    check(not bool(torch.allclose(off.float(), want.float(), rtol=tol[0],
                                  atol=tol[1])),
          f"{name}: the tolerance cannot tell {drop} dropped last key(s)")
    return err, tol[2]


def flash_invariance(gen, dev, dtype, hd: int = 64) -> dict:
    """A query row's result depends only on its position and the keys it
    sees: rows of one prefill are bitwise the same alone in the batch, in a
    shorter prefill of the same prompt, and computed behind a query offset
    over a longer key buffer whose rows past the last visible key hold NaN
    (the prefix-sharing admission)."""
    from repro_torch.kernels import flash_attention as FA
    B, H, nkv, S, cut = 3, 4, 2, 150, 70
    q, k, v = flash_inputs(gen, B, H, nkv, S, S, hd, dtype, dev)
    full = FA.attend(q, k, v, True)
    alone = FA.attend(q[1:2], k[1:2], v[1:2], True)
    shorter = FA.attend(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], True)
    pad = torch.full((B, nkv, 50, hd), float("nan"), dtype=dtype, device=dev)
    kb, vb = torch.cat([k, pad], dim=2), torch.cat([v, pad], dim=2)
    behind = FA.attend(q[:, :, cut:], kb, vb, True,
                       qoff=torch.full((B,), cut, dtype=torch.int32,
                                       device=dev))
    strided = FA.attend(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        True)
    torch.cuda.synchronize()
    out = dict(alone_in_batch=bool(torch.equal(alone[0], full[1])),
               shorter_prefill=bool(torch.equal(shorter, full[:, :, :cut])),
               behind_query_offset=bool(torch.equal(behind, full[:, :, cut:])),
               strided_layout=bool(torch.equal(strided, full)))
    check(all(out.values()), f"flash_attention is not batch / position "
                             f"invariant ({dtype_key(dtype)}): {out}")
    return out


def moe_route(name: str, dtype, d: int, f: int) -> str:
    """The route a MoE kernel's wrapper takes for (dtype, d, f): the int8
    pair's (``moe_tc.route_q``) or the bf16 pair's (``moe_tc.route``)."""
    from repro_torch.kernels import moe_tc
    return (moe_tc.route_q if name.endswith("_q") else moe_tc.route)(
        dtype, d, f)


def took_route(kernel, rows: int, d: int, f: int, dtype, fn):
    """``fn()``, a call of ``kernel``'s wrapper over ``rows`` rows, launched
    once on the route of (dtype, d, f) and on no other (no launch for no
    rows). Returns what it returned."""
    before = dict(kernel.ROUTE_LAUNCHES)
    out = fn()
    want = dict(before)
    if rows > 0:
        want[moe_route(kernel.name, dtype, d, f)] += 1
    check(kernel.ROUTE_LAUNCHES == want,
          f"{kernel.name}: launches by route {kernel.ROUTE_LAUNCHES}, expected "
          f"{want} (d={d}, f={f}, {dtype_key(dtype)})")
    return out


def case_list(dev):
    """The case lists of tests/test_torch_kernels.py, test_torch_kernels_q.py,
    test_torch_paged_attention.py, test_torch_flash.py and the reference's
    swiglu cases at their reduced shapes, for all eight kernels. The bf16
    gather / grouped cases take the tensor-core route at widths that are
    multiples of 8 (int8 tables: 16) and the CUDA-core one at other widths
    (checked per call), and the bf16-table ones are held to the plain
    version at fp32 as well. In bf16 the int8 grouped cases run again at
    widths that are multiples of 16 (32, 48), on the tensor-core route."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import decode_moe, grouped_mlp, ops
    from repro_torch.kernels import swiglu as SW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    gen = torch.Generator(device=dev).manual_seed(42)
    n = 0
    worst = {}
    invariance = {}

    def note(name, err):
        nonlocal n
        worst[name] = max(worst.get(name, 0.0), err)
        n += 1

    for dtype in (torch.float32, torch.bfloat16):
        key = dtype_key(dtype)
        for name, sizes in GROUPED_CASES.items():
            d, f = (23, 31) if name == "odd-widths" else (24, 32)
            E, T = len(sizes), sum(sizes)
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            wg, wu, wd = tables(gen, E, d, f, dtype, dev)
            gs = torch.tensor(sizes, device=dev)
            got = took_route(grouped_mlp.GROUPED, T, d, f, dtype,
                             lambda: grouped_mlp.grouped_swiglu(x, wg, wu, wd,
                                                                gs))
            plain = ops.KERNELS["grouped_swiglu"].plain
            err, _ = compare(f"grouped_swiglu[{name},{key}]", got,
                             plain(x, wg, wu, wd, gs), dtype)
            note("grouped_swiglu", err)
            if dtype == torch.bfloat16:
                want = plain(x.float(), wg.float(), wu.float(), wd.float(), gs)
                compare(f"grouped_swiglu[{name},{key}] vs fp32", got, want,
                        dtype, moe_tol32(want))
            widths = [(d, f)] + ([(32, 48)] if dtype == torch.bfloat16
                                 and name != "odd-widths" else [])
            for dq, fq in widths:
                if (dq, fq) != (d, f):
                    x = (torch.randn((T, dq), generator=gen, device=dev)
                         * 0.5).to(dtype)
                    wg, wu, wd = tables(gen, E, dq, fq, dtype, dev)
                qt = Q.quantize_expert_tables(wg, wu, wd)
                got = took_route(
                    grouped_mlp.GROUPED_Q, T, dq, fq, dtype,
                    lambda: grouped_mlp.grouped_swiglu_q(x, qt, gs))
                err, _ = compare(
                    f"grouped_swiglu_q[{name},{dq}x{fq},{key}]", got,
                    ops.KERNELS["grouped_swiglu_q"].plain(x, qt, gs), dtype)
                note("grouped_swiglu_q", err)
        for name, (T, d, f, E, k, idx, live) in GATHER_CASES.items():
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            wg, wu, wd = tables(gen, E, d, f, dtype, dev, live=live)
            if idx is None:
                idx = torch.randint(0, live or E, (T, k), generator=gen,
                                    device=dev)
            else:
                idx = torch.tensor(idx, device=dev)
            idx = idx.to(torch.int32)
            w = torch.softmax(torch.randn((T, k), generator=gen, device=dev), -1)
            got = took_route(decode_moe.GATHER, T * k, d, f, dtype,
                             lambda: decode_moe.gather_swiglu(x, wg, wu, wd,
                                                              idx, w))
            plain = ops.KERNELS["gather_swiglu"].plain
            err, _ = compare(f"gather_swiglu[{name},{key}]", got,
                             plain(x, wg, wu, wd, idx, w), dtype)
            note("gather_swiglu", err)
            if dtype == torch.bfloat16:
                want = plain(x.float(), wg.float(), wu.float(), wd.float(),
                             idx, w)
                compare(f"gather_swiglu[{name},{key}] vs fp32", got, want,
                        dtype, moe_tol32(want))
            qt = Q.quantize_expert_tables(wg, wu, wd)
            got = took_route(decode_moe.GATHER_Q, T * k, d, f, dtype,
                             lambda: decode_moe.gather_swiglu_q(x, qt, idx, w))
            err, _ = compare(f"gather_swiglu_q[{name},{key}]", got,
                             ops.KERNELS["gather_swiglu_q"].plain(
                                 x, qt, idx, w), dtype)
            note("gather_swiglu_q", err)
        for name, (T, d, f) in SWIGLU_CASES.items():
            if dtype == torch.bfloat16 and (d % 8 or f % 8):
                x = torch.zeros((T, d), dtype=dtype, device=dev)
                wg, wu, wd = [w[0] for w in tables(gen, 1, d, f, dtype, dev)]
                check_refused(lambda: SW.swiglu_mlp(x, wg, wu, wd),
                              f"swiglu_mlp[{name},{key}]")
                n += 1
                d, f = up_to(d, 8), up_to(f, 8)
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            wg, wu, wd = [w[0] for w in tables(gen, 1, d, f, dtype, dev)]
            got = SW.swiglu_mlp(x, wg, wu, wd)
            err, _ = compare(f"swiglu_mlp[{name},{key}]", got,
                             ops.KERNELS["swiglu_mlp"].plain(x, wg, wu, wd),
                             dtype)
            note("swiglu_mlp", err)
        # the reference's zero-weights case: exactly 0
        x = (torch.randn((16, 8), generator=gen, device=dev) * 0.5).to(dtype)
        z = torch.zeros((8, 16), dtype=dtype, device=dev)
        zero = SW.swiglu_mlp(x, z, z, z.t().contiguous())
        torch.cuda.synchronize()
        check(zero.shape == (16, 8) and bool((zero == 0).all()),
              f"swiglu_mlp[zero weights,{key}]: not exactly 0")
        n += 1
        for name, (B, nq, nkv, hd, bs, mb) in PAGED_CASES.items():
            nb = B * mb + 2
            q, kp, vp, tab, lens = paged_inputs(gen, B, nq, nkv, hd, nb, bs,
                                                mb, dtype, dev)
            for int8 in (False, True):
                kname = "paged_attention_q" if int8 else "paged_attention"
                got, want, _, vmax, want_of = paged_pair(q, kp, vp, tab, lens,
                                                         int8)
                err, _ = compare(f"{kname}[{name},{key}]", got, want, dtype,
                                 attn_tol_for(dtype, want, vmax))
                check_sees_dropped_row(f"{kname}[{name},{key}]", want_of, lens,
                                       dtype, vmax)
                note(kname, err)
        # blocks a slot does not own and rows past lens may hold anything,
        # NaN included: the kernel never loads them, so no output bit moves
        B, nq, nkv, hd, bs, mb = 3, 8, 2, 32, 8, 3
        nb = B * mb + 2
        q, kp, vp, tab, lens = paged_inputs(gen, B, nq, nkv, hd, nb, bs, mb,
                                            dtype, dev)
        owned = set(tab.reshape(-1).tolist()) - {nb}
        kp2, vp2 = kp.clone(), vp.clone()
        for blk in range(nb):
            if blk not in owned:
                kp2[blk] = float("nan")
                vp2[blk] = float("nan")
        for b in range(B):
            last = int(tab[b, (int(lens[b]) - 1) // bs])
            kp2[last, (int(lens[b]) - 1) % bs + 1:] = float("nan")
            vp2[last, (int(lens[b]) - 1) % bs + 1:] = float("nan")
        clean = PA.paged_attention(q, kp, vp, tab, lens)
        poisoned = PA.paged_attention(q, kp2, vp2, tab, lens)
        torch.cuda.synchronize()
        check(bool(torch.equal(clean, poisoned)),
              f"paged_attention[poisoned unowned blocks,{key}]: output moved")
        # lens == 0: finite zeros; the other rows as before
        lens0 = lens.clone()
        lens0[0] = 0
        y0 = PA.paged_attention(q, kp, vp, tab, lens0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y0).all()) and bool((y0[0] == 0).all())
              and bool(torch.equal(y0[1:], clean[1:])),
              f"paged_attention[lens=0,{key}]: not finite zeros")
        # a contiguous table makes the pool a dense cache: the dense attention
        from repro_torch.models.layers import _sdpa
        nb = B * mb
        tabc = torch.arange(nb, dtype=torch.int32, device=dev).reshape(B, mb)
        got = PA.paged_attention(q, kp[:nb].contiguous(), vp[:nb].contiguous(),
                                 tabc, lens)
        kc = kp[:nb].reshape(B, mb * bs, nkv, hd).float()
        vc = vp[:nb].reshape(B, mb * bs, nkv, hd).float()
        valid = (torch.arange(mb * bs, device=dev)[None, :]
                 < lens[:, None])[:, None, None, :]
        dense = _sdpa(q.float()[:, None], kc, vc, valid, nq // nkv)[:, 0]
        err, _ = compare(f"paged_attention[contiguous==dense,{key}]", got,
                         dense, dtype,
                         attn_tol_for(dtype, dense, float(vc.float().abs().max())))
        note("paged_attention", err)
        n += 2
        n += paged_split_checks(gen, dev, dtype, note)
        q, k, v = flash_inputs(gen, 1, 2, 1, 8, 8, 272, dtype, dev)
        check_refused(lambda: FA.attend(q, k, v, True),
                      f"flash_attention[hd 272,{key}]")
        n += 1
        for name, (B, H, nkv, Sq, Sk, hd, causal, off) in FLASH_CASES.items():
            if dtype == torch.bfloat16 and hd % 8:
                q, k, v = flash_inputs(gen, B, H, nkv, Sq, Sk, hd, dtype, dev)
                check_refused(lambda: FA.attend(q, k, v, causal),
                              f"flash_attention[{name},{key}]")
                n += 1
                hd = up_to(hd, 8)
            q, k, v = flash_inputs(gen, B, H, nkv, Sq, Sk, hd, dtype, dev)
            qoff = (None if off is None else
                    torch.tensor(off, dtype=torch.int32, device=dev))
            got = FA.attend(q, k, v, causal, qoff=qoff)
            err, _ = check_flash(f"flash_attention[{name},{key}]", got, q, k,
                                 v, causal, dtype, qoff)
            note("flash_attention", err)
            if H == nkv and qoff is None:
                # the reference's signature (ops, expanded heads) == attend
                via_ops = ops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check(bool(torch.equal(via_ops, got)),
                      f"ops.flash_attention[{name},{key}] != attend")
        invariance[key] = flash_invariance(gen, dev, dtype)
        invariance[key + ", hd 80"] = flash_invariance(gen, dev, dtype, hd=80)
        n += 2
    return n, worst, invariance


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    and replayed, so no host work sits between the launches (time_ms of a
    kernel shorter than its wrapper's host call measures the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=5) / calls


def bound_ms(dtype, n_rows: int, experts_hit: int, d: int, f: int,
             io_bytes: int, int8: bool = False):
    """Least time the card could take: the larger of bytes / memory rate
    (each input read once, each output written once: the three tables of
    every expert that is HIT, plus activations and indices) and operations /
    peak rate of the type (2*3*d*f per row). Int8 tables: one byte a weight
    plus the fp32 scales of its (2f + d) output channels. The operations run
    at the activations' peak: with bf16 x the products x . q are exact on
    bf16 operands (int8 -> bf16 is exact), so the bf16 peak; fp32 x, the
    fp32 peak."""
    peak = PEAK_FLOPS[dtype]
    if int8:
        per_expert = 3 * d * f + 4 * (2 * f + d)
    else:
        per_expert = 3 * d * f * torch.empty((), dtype=dtype).element_size()
    t_bytes = (experts_hit * per_expert + io_bytes) / HBM_BYTES_PER_S
    t_ops = (n_rows * 2 * 3 * d * f) / peak
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def attn_bound_ms(q, lens, nkv: int, pool_elt: int, int8: bool):
    """Paged decode attention: each valid row's K and V of every kv head read
    once (int8: one byte an element plus its fp32 scale), q read and the
    output written once, the table's used entries and lens; operations
    2*hd for q.k and 2*hd for p.v per (row, query head), in fp32."""
    B, nq, hd = q.shape
    rows = int(lens.to(torch.long).sum())
    kv = rows * nkv * 2 * (hd * pool_elt + (4 if int8 else 0))
    io = 2 * q.numel() * q.element_size() + 4 * (B + rows)
    t_bytes = (kv + io) / HBM_BYTES_PER_S
    t_ops = rows * nq * 4 * hd / PEAK_FLOPS[torch.float32]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def route_like_the_model(gen, T, k, n_orig, E, dev):
    """Expert ids as the serving path produces them: k DISTINCT original
    experts per token, mapped onto E stored experts by ``i % E`` (the remap
    of a freshly built merged layer), so a merged table sees duplicates."""
    scores = torch.rand((T, n_orig), generator=gen, device=dev)
    idx = scores.topk(k, dim=-1).indices
    return (idx % E).to(torch.int32)


def sort_pairs(idx, E, k):
    """(order, inverse order, group sizes) of a [T, k] id table sorted by
    expert, stably, as the ragged path sorts it."""
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(flat.numel(), device=idx.device)
    return order, inv, torch.bincount(flat, minlength=E)


#: the numbers of a MoE kernel's record that ride along beside its main one
MOE_TIMED_KEYS = ("shape", "route", "experts_hit", "max_err", "ms",
                  "device_ms", "plain_ms", "bound_ms", "bound_by",
                  "previous_ms", "previous_device_ms", "ms_with_combine",
                  "device_ms_with_combine", "previous_device_ms_with_combine")


def moe_tol32(want: torch.Tensor):
    """A bf16 MoE kernel against its plain version fed the same inputs
    widened to fp32 (exactly), which rounds nothing before the output: the
    kernel rounds h, each pair's y and the output to bf16, half an ulp each
    and not correlated: two bf16 ulps of max|y|."""
    scale = max(float(want.float().abs().max()), 1e-6) if want.numel() else 1.0
    return 0.0, 2 * scale / 128, ("vs the plain version at fp32 (the kernel "
                                  "rounds h, y and the output to bf16): atol "
                                  "2 bf16 ulps of max|y|")


def moe_tol_q(want: torch.Tensor):
    """An int8 MoE kernel on tensor cores against its plain version (each
    weight dequantized in fp32, h fp32, one rounding at the output). The
    kernel sums x . q in fp32 in another order and scales after the sum (a
    few fp32 ulps), keeps h as bf16 hi + lo (2^-16 of |h|) and rounds y once
    (half a bf16 ulp): two bf16 ulps of max|y|, as ``moe_tol32``."""
    rtol, atol, _ = moe_tol32(want)
    return rtol, atol, ("vs the plain version (fp32 dequantized tables, h "
                        "fp32; the kernel scales after the sum, keeps h as "
                        "bf16 hi + lo and rounds y once): atol 2 bf16 ulps "
                        "of max|y|")


def q_rows_h_bf16(x, qt, eid, chunk: int = 32):
    """Row r of ``x`` through int8 expert ``eid[r]`` as the plain version
    computes it (fp32 dequantized tables, fp32 sums) but with h rounded once
    to bf16 between the passes: what a kernel that dropped h's lo half would
    compute. [n, d] bf16."""
    import torch.nn.functional as F
    out = torch.empty((x.shape[0], x.shape[1]), dtype=torch.bfloat16,
                      device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        e = eid[r0:r0 + chunk]
        xr = x[r0:r0 + chunk].float().unsqueeze(1)
        g = torch.bmm(xr, qt.wg[e].float() * qt.wg_scale[e])
        u = torch.bmm(xr, qt.wu[e].float() * qt.wu_scale[e])
        h = (F.silu(g) * u).to(torch.bfloat16).float()
        y = torch.bmm(h, qt.wd[e].float() * qt.wd_scale[e])
        out[r0:r0 + chunk] = y.squeeze(1).to(torch.bfloat16)
    return out


def check_h_keeps_lo(name, got, want32, h_bf16) -> dict:
    """The int8 tensor-core kernel carries h as bf16 hi + lo: summed over
    every output, its distance to the plain version (h fp32, output fp32)
    must be below that of the same plain arithmetic with h rounded once to
    bf16 (``h_bf16``), which a kernel that dropped or zeroed lo would
    match instead."""
    gap = float((got.float() - want32.float()).abs().sum())
    gap16 = float((h_bf16.float() - want32.float()).abs().sum())
    check(gap < gap16, f"{name}: summed |y - plain| {gap} is not below the "
                       f"bf16-h variant's {gap16}: h's lo half is not used")
    return dict(sum_abs_err_vs_plain_fp32=gap,
                sum_abs_err_h_bf16_vs_plain_fp32=gap16,
                gap_share_of_h_bf16=gap / gap16)


def previous_moe(name, x, wg, wu, wd, ids, w=None):
    """One call of the CUDA-core kernel that the bf16 route ran before its
    tensor-core one (the ``previous_ms`` yardstick), through its C entry
    point and not its wrapper (so no launch is counted; the wrappers never
    reach it in bf16 at these widths). ``name``: gather_swiglu (ids: idx
    [T, k], w [T, k]) or grouped_swiglu (ids: group sizes [E]); the int8
    pair (wg: the ``QuantizedExpertTables``, wu / wd unused): gather_swiglu_q
    (ids: idx [T, k]; the per-pair rows [T, k, d], as the kernel emits them,
    or with w the rows combined by the kernel's combine pass) or
    grouped_swiglu_q (ids: group sizes [E])."""
    from repro_torch.kernels import _common, grouped_mlp
    T, d = x.shape
    int8 = name.endswith("_q")
    if int8:
        qt = wg
        E, _, f = qt.wg.shape
        ptrs = [x.data_ptr()] + [t.data_ptr() for t in qt]
        hdt = torch.float32
    else:
        E, _, f = wg.shape
        ptrs = [x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr()]
        hdt = x.dtype
    if name.startswith("gather"):
        k = ids.shape[1]
        idx32 = ids.to(torch.int32).contiguous()
        h = torch.empty((T * k, f), dtype=hdt, device=x.device)
        y = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
        ints = [T, E, d, f, k]
        w32 = None if w is None else w.to(torch.float32).contiguous()
        out = y.reshape(T, k, d) if w is None else torch.empty_like(x)
        ptrs += [idx32.data_ptr(), None if w is None else w32.data_ptr()]
        if int8:
            ptrs += [h.data_ptr(), y.data_ptr(),
                     None if w is None else out.data_ptr()]
        else:
            ptrs += [h.data_ptr(), y.data_ptr(), out.data_ptr()]
        tail = []
    else:
        gs32 = ids.to(torch.int32).contiguous()
        h = torch.empty((T, f), dtype=hdt, device=x.device)
        out = torch.empty_like(x)
        ptrs += [gs32.data_ptr(), h.data_ptr(), out.data_ptr()]
        ints = [T, E, d, f]
        tail = [grouped_mlp.rows_per_block(d, f)]
    tail.append(_common.DTYPE_CODES[x.dtype])
    fn = _common.launcher(f"{name}_launch", len(ptrs), len(ints) + len(tail))
    _common.check_launch(name, fn(*ptrs, *ints, *tail, _common.stream_of(x)))
    return out


def moe_tc_timings(name, x, wg, wu, wd, ids, w=None) -> dict:
    """The CUDA-core kernel the bf16 route ran before (``previous_ms``),
    timed in this run beside the tensor-core kernels."""
    def previous():
        return previous_moe(name, x, wg, wu, wd, ids, w)
    return dict(previous_ms=time_ms(previous, reps=10),
                previous_device_ms=graph_ms(previous, calls=10))


def gather_tc_checks(gen, n_orig, x, idx, w, got, call, plain, name,
                     tol32, qt=None) -> dict:
    """A gather kernel on tensor cores (``call(x, idx, w)``: the bf16 form's
    combined rows, the int8 form's per-pair rows; ``plain`` the same in the
    plain version): against the plain version on fp32-widened inputs
    (``tol32``); a token's row alone == among the 8 slots == among 64
    tokens, and a token's row among 128 pairs of one expert (two 64-row
    tiles, held to the plain version too) == alone, bitwise. With the int8
    tables ``qt``, also :func:`check_h_keeps_lo`."""
    T, d = x.shape
    k = idx.shape[1]
    dev, dtype = x.device, x.dtype
    E = plain.n_experts
    want32 = plain(x.float(), idx, w, fp32=True)
    err32, words32 = compare(f"{name}[T={T},E={E},bfloat16] vs fp32", got,
                             want32, dtype, tol32(want32))
    lo_used = {}
    if qt is not None:
        eid = idx.reshape(-1).long().clamp(0, E - 1)
        lo_used = check_h_keeps_lo(
            f"{name}[T={T},E={E}]", got, want32,
            q_rows_h_bf16(x.repeat_interleave(k, dim=0), qt, eid)
            .reshape(got.shape))

    def tokens(n, ids=None):
        xn = (torch.randn((n, d), generator=gen, device=dev) * 0.5).to(dtype)
        if ids is None:
            ids = route_like_the_model(gen, n, k, n_orig, E, dev)
        return xn, ids, torch.softmax(torch.randn((n, k), generator=gen,
                                                  device=dev), -1)
    alone = call(x[3:4], idx[3:4], w[3:4])
    xm, im, wm = tokens(64 - T)
    many = call(torch.cat([x, xm]), torch.cat([idx, im]), torch.cat([w, wm]))
    x16, i16, w16 = tokens(16, torch.full((16, k), int(idx[0, 0]),
                                          dtype=torch.int32, device=dev))
    two_tiles = call(x16, i16, w16)
    compare(f"{name}[16 x {k} pairs of one expert,E={E},bfloat16]",
            two_tiles, plain(x16, i16, w16), dtype)
    one = call(x16[9:10], i16[9:10], w16[9:10])
    torch.cuda.synchronize()
    inv = dict(row_alone_vs_among_8_tokens=bool(torch.equal(alone[0], got[3])),
               among_8_vs_among_64_tokens=bool(torch.equal(many[:T], got)),
               row_alone_vs_among_128_pairs_of_one_expert=bool(
                   torch.equal(one[0], two_tiles[9])))
    check(all(inv.values()), f"{name} (tensor cores, E={E}): a row's bits "
                             f"depend on its neighbours: {inv}")
    return dict(max_err_vs_plain_fp32=err32, tol_vs_plain_fp32=words32,
                invariance_bitwise=inv, **lo_used)


def grouped_tc_checks(gen, xs, gs, got, call, plain, name, tol32,
                      qt=None) -> dict:
    """A grouped kernel on tensor cores (``call(rows, group_sizes)``,
    ``plain`` the same in the plain version): against the plain version on
    fp32-widened inputs (``tol32``); rows alone (a segment of 1) == among 8
    == among 64 == among all, and the rows of a segment of 100 rows of one
    expert (two 64-row tiles, held to the plain version too) == each alone,
    bitwise. With the int8 tables ``qt``, also :func:`check_h_keeps_lo`."""
    from repro_torch.kernels.ref import rows_to_experts
    T, d = xs.shape
    E = plain.n_experts
    dev, dtype = xs.device, xs.dtype
    want32 = plain(xs.float(), gs, fp32=True)
    err32, words32 = compare(f"{name}[T={T},E={E},bfloat16] vs fp32", got,
                             want32, dtype, tol32(want32))
    lo_used = {}
    if qt is not None:
        lo_used = check_h_keeps_lo(f"{name}[T={T},E={E}]", got, want32,
                                   q_rows_h_bf16(xs, qt,
                                                 rows_to_experts(gs, T)))

    def one_group(e, n):
        sizes = torch.zeros((E,), dtype=torch.int32, device=dev)
        sizes[e] = n
        return sizes
    eid = rows_to_experts(gs, T)
    rows = (0, 5, T - 1)
    alone = [call(xs[i:i + 1], one_group(int(eid[i]), 1)) for i in rows]
    cum = torch.cumsum(gs, 0)
    among = {n: call(xs[:n].contiguous(),
                     cum.clamp(max=n) - (cum - gs).clamp(max=n))
             for n in (8, 64)}
    x100 = (torch.randn((100, d), generator=gen, device=dev) * 0.5).to(dtype)
    seg = call(x100, one_group(int(eid[0]), 100))
    compare(f"{name}[segment of 100,E={E},bfloat16]", seg,
            plain(x100, one_group(int(eid[0]), 100)), dtype)
    singles = {i: call(x100[i:i + 1], one_group(int(eid[0]), 1))
               for i in (0, 63, 64, 99)}
    torch.cuda.synchronize()
    inv = dict(row_alone_vs_among_all=all(
        torch.equal(a[0], got[i]) for a, i in zip(alone, rows)),
        **{f"among_{n}_vs_among_all": bool(torch.equal(y, got[:n]))
           for n, y in among.items()},
        segment_of_1_vs_segment_of_100=all(
            torch.equal(y[0], seg[i]) for i, y in singles.items()))
    check(all(inv.values()), f"{name} (tensor cores, E={E}): a row's bits "
                             f"depend on its neighbours: {inv}")
    return dict(max_err_vs_plain_fp32=err32, tol_vs_plain_fp32=words32,
                invariance_bitwise=inv, **lo_used)


class Plain:
    """The plain version of one MoE form over fixed tables, called like the
    checks call the kernel: ``(rows, ids[, w][, fp32=True])`` where
    ``fp32`` widens the bf16 tables first (the int8 form's plain version is
    fp32 inside already and takes the rows widened)."""

    def __init__(self, fn, tabs, int8: bool):
        self.fn, self.tabs, self.int8 = fn, tabs, int8
        self.n_experts = (tabs[0].wg if int8 else tabs[0]).shape[0]

    def __call__(self, rows, *ids, fp32=False):
        tabs = self.tabs
        if fp32 and not self.int8:
            tabs = [t.float() for t in tabs]
        return self.fn(rows, *tabs, *ids)


def main_path_shapes(dev, cfg, admission_rows: int, paged_lens, dense_cfg):
    """Every kernel at the shapes the serve phase gives it, full width (the
    paged kernels also at the dense phase's heads, ``dense_cfg``)."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import decode_moe, grouped_mlp, ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import combine_in_order
    from repro_torch.kernels import moe_tc
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    N, k = cfg.moe.n_experts, cfg.moe.top_k
    gen = torch.Generator(device=dev).manual_seed(7)
    # the int8 pair's checks draw their own inputs, so the timed inputs stay
    # those of the trees before them (comparable across trees)
    gen_q = torch.Generator(device=dev).manual_seed(17)
    checks, entries, records = [], {}, {}
    quant_bitwise = None
    for dtype in (torch.bfloat16, torch.float32):
        key = dtype_key(dtype)
        size = torch.empty((), dtype=dtype).element_size()
        full = tables(gen, N, d, f, dtype, dev)
        for E in (N, N // 2):
            wg, wu, wd = [w[:E].contiguous() for w in full]
            qt = Q.quantize_expert_tables(wg, wu, wd)
            if quant_bitwise is None:
                # one full-width layer quantized on the card and on the CPU
                on_cpu = Q.quantize_expert_tables(wg.cpu(), wu.cpu(), wd.cpu())
                quant_bitwise = all(torch.equal(a.cpu(), b)
                                    for a, b in zip(qt, on_cpu))
                check(quant_bitwise, "quantize_expert_tables: the card's int8 "
                                     "tables or scales differ from the CPU's")
                del on_cpu
            # ---- gather: one decode step of the 8-slot engine
            T = 8
            x = (torch.randn((T, d), generator=gen, device=dev) * 0.5).to(dtype)
            idx = route_like_the_model(gen, T, k, N, E, dev)
            w = torch.softmax(torch.randn((T, k), generator=gen, device=dev), -1)
            order, inv, gs = sort_pairs(idx, E, k)
            hit = int((gs > 0).sum())
            io = 2 * T * d * size + T * k * 8
            got = decode_moe.gather_swiglu(x, wg, wu, wd, idx, w)
            plain = ops.KERNELS["gather_swiglu"].plain
            err, words = compare(f"gather_swiglu[T={T},E={E},{key}]", got,
                                 plain(x, wg, wu, wd, idx, w), dtype)
            # the same pairs through the grouped kernel + ordered combine
            ys = grouped_mlp.grouped_swiglu(x[order // k].contiguous(), wg, wu,
                                            wd, gs)
            via_grouped = combine_in_order(ys[inv].reshape(T, k, d), w).to(dtype)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, via_grouped))
            check(bitwise, f"gather != grouped bitwise at E={E}, {key}")
            b_ms, by = bound_ms(dtype, T * k, hit, d, f, io)

            def gather():
                return decode_moe.gather_swiglu(x, wg, wu, wd, idx, w)
            rec = dict(name="gather_swiglu", shape=f"T={T} k={k} E={E} d={d} "
                       f"f={f} {key}", route=moe_tc.route(dtype, d, f),
                       experts_hit=hit, max_err=err, tol=words,
                       ms=time_ms(gather, reps=20), device_ms=graph_ms(gather),
                       bound_ms=b_ms, bound_by=by,
                       plain_ms=time_ms(lambda: plain(x, wg, wu, wd, idx, w),
                                        reps=3, rounds=3),
                       bitwise_vs_grouped=bitwise)
            if dtype == torch.bfloat16:
                rec.update(gather_tc_checks(
                    gen, N, x, idx, w, got,
                    lambda r, i, v: decode_moe.gather_swiglu(r, wg, wu, wd, i,
                                                             v),
                    Plain(plain, [wg, wu, wd], False), "gather_swiglu",
                    moe_tol32),
                    **moe_tc_timings("gather_swiglu", x, wg, wu, wd, idx, w))
            checks.append(rec)
            records[("gather_swiglu", dtype, E)] = rec
            # ---- the int8 gather: per-pair rows [T, k, d], then (main path)
            # the slot-order combine
            rows = decode_moe.gather_swiglu_q_rows(x, qt, idx)
            err, words = compare(f"gather_swiglu_q[T={T},E={E},{key}]", rows,
                                 ref.gather_swiglu_q_rows(x, qt, idx), dtype)
            ysq = grouped_mlp.grouped_swiglu_q(x[order // k].contiguous(), qt, gs)
            combined = decode_moe.gather_swiglu_q(x, qt, idx, w)
            torch.cuda.synchronize()
            bitwise_q = bool(torch.equal(rows, ysq[inv].reshape(T, k, d)))
            check(bitwise_q, f"int8 gather != int8 grouped bitwise at E={E}, "
                             f"{key}")
            combine_q = bool(torch.equal(
                combined, combine_in_order(rows, w).to(dtype)))
            check(combine_q, f"int8 gather's combine != combine_in_order "
                             f"bitwise at E={E}, {key}")
            b_ms, by = bound_ms(dtype, T * k, hit, d, f,
                                T * d * size + T * k * (4 + d * size), int8=True)

            def gather_q():
                return decode_moe.gather_swiglu_q_rows(x, qt, idx)

            def gather_q_combined():
                return decode_moe.gather_swiglu_q(x, qt, idx, w)

            def previous_q_combined():
                return previous_moe("gather_swiglu_q", x, qt, None, None, idx,
                                    w)
            rec = dict(name="gather_swiglu_q", shape=f"T={T} k={k} E={E} d={d} "
                       f"f={f} int8 tables, x {key}",
                       route=moe_tc.route_q(dtype, d, f), experts_hit=hit,
                       max_err=err, tol=words, ms=time_ms(gather_q, reps=20),
                       device_ms=graph_ms(gather_q),
                       ms_with_combine=time_ms(gather_q_combined, reps=20),
                       device_ms_with_combine=graph_ms(gather_q_combined),
                       bound_ms=b_ms, bound_by=by,
                       plain_ms=time_ms(lambda: ref.gather_swiglu_q_rows(
                           x, qt, idx), reps=3, rounds=3),
                       bitwise_vs_grouped=bitwise_q,
                       combine_bitwise_vs_combine_in_order=combine_q)
            if dtype == torch.bfloat16:
                rec.update(**moe_tc_timings("gather_swiglu_q", x, qt, None,
                                            None, idx),
                           previous_device_ms_with_combine=graph_ms(
                               previous_q_combined))
                rec.update(gather_tc_checks(
                    gen_q, N, x, idx, w, rows,
                    lambda r, i, v: decode_moe.gather_swiglu_q_rows(r, qt, i),
                    Plain(lambda r, q, i, v: ref.gather_swiglu_q_rows(r, q, i),
                          [qt], True), "gather_swiglu_q", moe_tol_q, qt=qt))
            checks.append(rec)
            records[("gather_swiglu_q", dtype, E)] = rec
            # ---- grouped: the largest admission row of the serve phase
            Tg = admission_rows
            xg = (torch.randn((Tg // k, d), generator=gen, device=dev)
                  * 0.5).to(dtype)
            idg = route_like_the_model(gen, Tg // k, k, N, E, dev)
            order_g, _, gs_g = sort_pairs(idg, E, k)
            xs = xg[order_g // k].contiguous()
            hit = int((gs_g > 0).sum())
            for name, int8 in (("grouped_swiglu", False),
                               ("grouped_swiglu_q", True)):
                tabs = [qt] if int8 else [wg, wu, wd]
                kern = ops.KERNELS[name]
                wrapper = getattr(grouped_mlp, name)

                def fn(rows=xs, sizes=gs_g, wrapper=wrapper, tabs=tabs):
                    return wrapper(rows.contiguous(), *tabs, sizes)

                def pfn(plain=kern.plain, tabs=tabs):
                    return plain(xs, *tabs, gs_g)
                got = fn()
                err, words = compare(f"{name}[T={Tg},E={E},{key}]", got, pfn(),
                                     dtype)
                b_ms, by = bound_ms(dtype, Tg, hit, d, f,
                                    2 * Tg * d * size + E * 4, int8=int8)
                rec = dict(name=name, shape=f"T={Tg} E={E} d={d} f={f} "
                           f"{'int8 tables, x ' if int8 else ''}{key}",
                           route=moe_route(name, dtype, d, f),
                           experts_hit=hit, max_err=err, tol=words,
                           ms=time_ms(fn, reps=3, rounds=3),
                           device_ms=graph_ms(fn, calls=10), bound_ms=b_ms,
                           bound_by=by, plain_ms=time_ms(pfn, reps=1, rounds=3))
                if dtype == torch.bfloat16:
                    rec.update(moe_tc_timings(
                        name, xs, *tabs, *([None, None] if int8 else []), gs_g))
                    rec.update(grouped_tc_checks(
                        gen_q if int8 else gen, xs, gs_g, got, fn,
                        Plain(kern.plain, tabs, int8), name,
                        moe_tol_q if int8 else moe_tol32,
                        qt=tabs[0] if int8 else None))
                checks.append(rec)
                records[(name, dtype, E)] = rec
            del wg, wu, wd, qt, xs
        del full
        free()
    # the main entries: bf16 at E = N; the merged shape (E = N / 2) and the
    # fp32 CUDA-core route ride along
    for name in ("gather_swiglu", "grouped_swiglu", "gather_swiglu_q",
                 "grouped_swiglu_q"):
        entries[name] = dict(records[(name, torch.bfloat16, N)], merged_shape={
            key: val for key, val in records[(name, torch.bfloat16, N // 2)]
            .items() if key in MOE_TIMED_KEYS})
        if name in ROUTED:
            entries[name]["cuda_core_route"] = {
                key: val for key, val in records[(name, torch.float32, N)]
                .items() if key in MOE_TIMED_KEYS}
    # ---- paged attention at the serve shape: 8 slots, 32 / 4 heads, hd 128,
    # blocks of KV_BLOCK rows, s_max 512, lens of a decode step of the trace;
    # then at granite-8b's heads (32 / 8) with the same lens
    B, nq, hd = 8, cfg.n_heads, cfg.hd
    mb = 512 // KV_BLOCK
    nb = B * mb
    for arch_cfg in (cfg, dense_cfg):
        nkv = arch_cfg.n_kv_heads
        for dtype in (torch.bfloat16, torch.float32):
            key = dtype_key(dtype)
            if arch_cfg is dense_cfg and dtype == torch.float32:
                continue
            q, kp, vp, tab, lens = paged_inputs(gen, B, arch_cfg.n_heads,
                                                nkv, arch_cfg.hd, nb, KV_BLOCK,
                                                mb, dtype, dev,
                                                lens=paged_lens.to(dev))
            for int8 in (False, True):
                name = "paged_attention_q" if int8 else "paged_attention"
                got, want, want_typed, vmax, want_of = paged_pair(
                    q, kp, vp, tab, lens, int8)
                tag = f"{name}[serve,{arch_cfg.name},{key}]"
                err, words = compare(tag, got, want, dtype,
                                     attn_tol_for(dtype, want, vmax))
                check_sees_dropped_row(tag, want_of, lens, dtype, vmax)
                # reported: the plain version in the input type rounds the
                # softmax (and int8 pools' dequantized rows) to it
                err_typed = float((got.float() - want_typed.float()).abs().max())
                plain = ops.KERNELS[name].plain
                pools = paged_pools(int8, kp, vp)
                fn = (lambda: paged_run(q, pools, tab, lens))
                pfn = (lambda: plain(q, *[t for t in pools if t is not None],
                                     tab, lens))
                b_ms, by = attn_bound_ms(q, lens, nkv,
                                         1 if int8 else kp.element_size(),
                                         int8)
                rec = dict(name=name, shape=f"B={B} nq={arch_cfg.n_heads} "
                           f"nkv={nkv} hd={arch_cfg.hd} bs={KV_BLOCK} "
                           f"s_max={mb * KV_BLOCK} lens {lens.tolist()} "
                           f"{'int8 pool, q ' if int8 else ''}{key}",
                           max_err=err, tol=words,
                           max_err_vs_plain_in_input_type=err_typed,
                           ms=time_ms(fn, reps=50), device_ms=graph_ms(fn),
                           bound_ms=b_ms, bound_by=by,
                           plain_ms=time_ms(pfn, reps=10, rounds=3))
                checks.append(rec)
                if dtype != torch.bfloat16:
                    continue
                if arch_cfg is cfg:
                    entries[name] = rec
                else:
                    entries[name]["dense_family_shape"] = {
                        k: rec[k] for k in ("shape", "max_err", "ms",
                                            "device_ms", "bound_ms",
                                            "bound_by", "plain_ms")}
    return checks, entries, quant_bitwise


def flash_bound_ms(B, H, nkv, Sq, Sk, hd, dtype, causal=True):
    """Least time for one full-sequence attention: q, k, v read once and the
    output written once, against the operations these shapes need (2*hd for
    q.k and 2*hd for p.v per visible (query, key) pair) at the peak rate of
    the inputs' type."""
    es = torch.empty((), dtype=dtype).element_size()
    t_bytes = (2 * B * H * Sq * hd + 2 * B * nkv * Sk * hd) * es / HBM_BYTES_PER_S
    if causal:
        pairs = sum(max(0, min(Sk, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    t_ops = 4 * hd * B * H * pairs / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def library_attention_ms(q, k, v, timer=None) -> float:
    """One library call that computes the same causal attention (expanded
    heads, contiguous), timed only as a yardstick (by ``timer``, default
    time_ms): the port never calls it."""
    import torch.nn.functional as F

    def call():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return timer(call) if timer else time_ms(call, reps=20)


def flash_main_shapes(dev, cfg, shapes):
    """flash_attention at the main path's shapes (``shapes``: (label, B, S,
    dtype); bf16 takes the tensor-core route, fp32 the CUDA-core one), in the
    model's layout: q ``[B, S, H, hd]`` and the unexpanded K/V ``[B, S, nkv,
    hd]`` read through their strides, as ``layers._attend`` hands them over.
    Checked against the fp32 plain version, timed against its bound, the
    plain version and one library call."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(11)
    H, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    recs = []
    for label, B, S, dtype in shapes:
        qm = (torch.randn((B, S, H, hd), generator=gen, device=dev)
              * 4.0).to(dtype)
        km = (torch.randn((B, S, nkv, hd), generator=gen, device=dev)
              * 0.5).to(dtype)
        vm = (torch.randn((B, S, nkv, hd), generator=gen, device=dev)
              * 0.5).to(dtype)
        q, k, v = qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)

        def fn():
            return FA.attend(q, k, v, True)
        err, words = check_flash(f"flash_attention[{label}]", fn(), q, k, v,
                                 True, dtype)
        qc = q.contiguous()
        kx = k.repeat_interleave(H // nkv, dim=1).contiguous()
        vx = v.repeat_interleave(H // nkv, dim=1).contiguous()
        plain = ops.KERNELS["flash_attention"].plain
        b_ms, by = flash_bound_ms(B, H, nkv, S, S, hd, dtype)
        recs.append(dict(
            name="flash_attention", label=label, route=FA.route(dtype),
            shape=f"B={B} H={H} nkv={nkv} S={S} hd={hd} causal "
                  f"{dtype_key(dtype)}, model layout", max_err=err, tol=words,
            ms=time_ms(fn, reps=20), device_ms=graph_ms(fn),
            bound_ms=b_ms, bound_by=by,
            plain_ms=time_ms(lambda: plain(qc, kx, vx, causal=True), reps=3,
                             rounds=3),
            library_ms=library_attention_ms(qc, kx, vx),
            library_device_ms=library_attention_ms(qc, kx, vx, graph_ms),
            library="torch.nn.functional.scaled_dot_product_attention("
                    "is_causal=True), expanded heads"))
    return recs


def previous_mlp_apply(p, x):
    """The model's MLP on the card before the swiglu_mlp kernel, as the
    cuBLAS composition ``torch.mm`` x2, silu * mul, ``torch.mm`` over the
    flattened rows, every product rounded to the model type (g and u in
    bf16). A yardstick only, never called by the port: the kernels line's
    ``library_ms`` for swiglu_mlp and the other side of ``mlp_logit_gap``."""
    import torch.nn.functional as F
    rows = x.reshape(-1, x.shape[-1])
    h = F.silu(torch.mm(rows, p.wg)) * torch.mm(rows, p.wu)
    return torch.mm(h, p.wd).reshape(x.shape)


def mlp_weights(gen, d, f, dtype, dev):
    """One dense MLP at the model's scale (N(0, 1/fan_in) weights)."""
    return [(torch.randn(shape, generator=gen, device=dev)
             / shape[0] ** 0.5).to(dtype) for shape in ((d, f), (d, f), (f, d))]


def swiglu_main_shapes(dev, admission_rows: int):
    """swiglu_mlp at full width: granite-8b's decode (8 slots) and admission
    (the trace's largest bucket) shapes in bf16 (the tensor-core route) and
    the decode shape in fp32 (the CUDA-core route), checked against the plain
    version and timed beside its bound, the plain version and the cuBLAS
    composition the model's MLP ran before; widths past granite's f (yi-34b's
    f 20480, qwen1.5-110b's f 49152) and kimi-k2's shared expert, checked. At
    admission a row's result is the same alone, among 8, among 64 and among
    256, bitwise; in fp32 the kernel == grouped_swiglu with one group,
    bitwise (the two share the CUDA-core arithmetic; in bf16 the tensor-core
    route is held to its plain version instead). The same with ``round_gu``
    (the model's arithmetic, which ``mlp_apply`` runs) at the two bf16
    shapes, rows invariant in both settings, and ``round_gu`` the identity in
    fp32. Returns the records and the bf16 ones by label, with the fp32
    decode record under "fp32"."""
    from repro_torch import configs
    from repro_torch.kernels import grouped_mlp, ops
    from repro_torch.kernels import swiglu as SW
    gen = torch.Generator(device=dev).manual_seed(17)
    plain = ops.KERNELS["swiglu_mlp"].plain
    granite, yi, qwen = (configs.get(a) for a in (DENSE, "yi-34b",
                                                  "qwen1.5-110b"))
    kimi = configs.get("kimi-k2-1t-a32b")
    d, f = granite.d_model, granite.d_ff
    cases = [("decode", 8, d, f, torch.bfloat16, True),
             ("admission", admission_rows, d, f, torch.bfloat16, True),
             ("decode", 8, d, f, torch.float32, True),
             ("yi-34b widths", 4, yi.d_model, yi.d_ff, torch.bfloat16, False),
             ("qwen1.5-110b widths", 3, qwen.d_model, qwen.d_ff,
              torch.bfloat16, False),
             ("kimi-k2 shared expert, decode", 8, kimi.d_model,
              kimi.moe.n_shared_experts * kimi.moe.d_ff_expert,
              torch.bfloat16, False)]
    recs, entries = [], {}
    for label, T, dm, fm, dtype, timed in cases:
        key = dtype_key(dtype)
        wg, wu, wd = mlp_weights(gen, dm, fm, dtype, dev)
        x = torch.randn((T, dm), generator=gen, device=dev).to(dtype)
        got = SW.swiglu_mlp(x, wg, wu, wd)
        err, words = compare(f"swiglu_mlp[{label},{key}]", got,
                             plain(x, wg, wu, wd), dtype)
        rec = dict(name="swiglu_mlp", label=label, route=SW.route(dtype),
                   shape=f"T={T} d={dm} f={fm} {key}", max_err=err, tol=words)
        if timed:
            size = x.element_size()
            b_ms, by = bound_ms(dtype, T, 1, dm, fm, 2 * T * dm * size)
            p = types.SimpleNamespace(wg=wg, wu=wu, wd=wd)
            rec.update(ms=time_ms(lambda: SW.swiglu_mlp(x, wg, wu, wd),
                                  reps=10),
                       device_ms=graph_ms(
                           lambda: SW.swiglu_mlp(x, wg, wu, wd), calls=10),
                       bound_ms=b_ms, bound_by=by,
                       plain_ms=time_ms(lambda: plain(x, wg, wu, wd), reps=3,
                                        rounds=3),
                       library_ms=time_ms(lambda: previous_mlp_apply(p, x),
                                          reps=20),
                       library_device_ms=graph_ms(
                           lambda: previous_mlp_apply(p, x), calls=10),
                       library="cuBLAS composition (previous_mlp_apply): "
                               "torch.mm x2, silu * mul, torch.mm, the "
                               "model's MLP before this kernel")
            entries[label if dtype == torch.bfloat16 else "fp32"] = rec
        if timed and dtype == torch.bfloat16:
            # the model's arithmetic (g and u rounded), what mlp_apply runs
            got_r = SW.swiglu_mlp(x, wg, wu, wd, round_gu=True)
            err_r, words_r = compare(
                f"swiglu_mlp[{label},{key},round_gu]", got_r,
                plain(x, wg, wu, wd, round_gu=True), dtype)
            rec["round_gu"] = dict(
                max_err=err_r, tol=words_r,
                ms=time_ms(lambda: SW.swiglu_mlp(x, wg, wu, wd, round_gu=True),
                           reps=10),
                device_ms=graph_ms(lambda: SW.swiglu_mlp(
                    x, wg, wu, wd, round_gu=True), calls=10))
        if label == "admission":
            # rows alone and among 8, 64 and all T, bitwise, with and
            # without round_gu
            rows = (0, 5, T - 1)
            for option, full in ((False, got), (True, got_r)):
                def mlp(a):
                    return SW.swiglu_mlp(a.contiguous(), wg, wu, wd,
                                         round_gu=option)
                alone = [mlp(x[i:i + 1]) for i in rows]
                among = {n: mlp(x[:n]) for n in (8, 64)}
                torch.cuda.synchronize()
                inv = {"row_alone_vs_among_all_bitwise": all(
                    torch.equal(a[0], full[i]) for a, i in zip(alone, rows)),
                    **{f"among_{n}_vs_among_all_bitwise": bool(
                        torch.equal(y, full[:n])) for n, y in among.items()}}
                (rec["round_gu"] if option else rec).update(inv)
                check(all(inv.values()), f"swiglu_mlp (round_gu={option}): a "
                                         f"row differs alone and among other "
                                         f"rows")
        if dtype == torch.float32 and label == "decode":
            one = grouped_mlp.grouped_swiglu(
                x, wg[None], wu[None], wd[None],
                torch.tensor([T], dtype=torch.int32, device=dev))
            same = SW.swiglu_mlp(x, wg, wu, wd, round_gu=True)
            torch.cuda.synchronize()
            rec["bitwise_vs_grouped_one_group"] = bool(torch.equal(got, one))
            rec["round_gu_is_the_identity_bitwise"] = bool(
                torch.equal(got, same))
            check(rec["bitwise_vs_grouped_one_group"],
                  "swiglu_mlp != grouped_swiglu with one group, bitwise (fp32)")
            check(rec["round_gu_is_the_identity_bitwise"],
                  "swiglu_mlp: round_gu changed an fp32 result")
        recs.append(rec)
        del wg, wu, wd, x
        free()
    return recs, entries


def threefry_on_the_card(dev) -> dict:
    """The sampling noise of a batch of (key, position) pairs on the card
    against the CPU: threefry bits and uniforms bitwise, the Gumbel noise to
    2 ulps of max(|g|, 1) (the card's and the CPU's ``log`` may round
    differently; near g = 0 one ulp of the inner log's argument is many ulps
    of g)."""
    from repro_torch.core import threefry as TF
    out = {}
    for V in (49152, 151936):
        keys = TF.fold_in(TF.prng_key(1), torch.tensor([0, 3, 7, 2**31 - 1]))
        pos = torch.tensor([0, 100, 511, 2**31 - 1])
        k_cpu = TF.fold_in(keys, pos)
        k_gpu = TF.fold_in(keys.to(dev), pos.to(dev))
        bits = torch.equal(k_gpu.cpu(), k_cpu) and torch.equal(
            TF.random_bits(k_gpu, V).cpu(), TF.random_bits(k_cpu, V))
        uni = torch.equal(TF.uniform(k_gpu, V, TF.TINY).cpu(),
                          TF.uniform(k_cpu, V, TF.TINY))
        g_cpu, g_gpu = TF.gumbel(k_cpu, V), TF.gumbel(k_gpu, V).cpu()
        ulp = torch.maximum(g_cpu.abs(), torch.ones_like(g_cpu))
        ulp = (torch.nextafter(ulp, torch.full_like(ulp, float("inf"))) - ulp)
        gap = float(((g_gpu - g_cpu).abs() / ulp).max())
        out[f"vocab {V}"] = dict(bits_bitwise=bits, uniform_bitwise=uni,
                                 gumbel_max_gap_ulps_of_max_abs_g_1=gap,
                                 gumbel_bitwise=bool(torch.equal(g_gpu, g_cpu)))
        check(bits and uni, f"threefry on the card differs from the CPU "
                            f"(vocab {V})")
        check(gap <= 2.0, f"Gumbel noise on the card {gap} ulps from the CPU's")
    return out


# ---------------------------------------------------------------------------
# the trace and the engine
# ---------------------------------------------------------------------------

#: the requests of the trace that share one 128-token prompt prefix
SHARERS = (1, 5, 9, 13)
PREFIX = 128


def make_trace(vocab: int, seed: int, n_requests: int = 16, new_tokens: int = 32):
    """Poisson arrivals, prompts of 32 to 256 tokens; requests SHARERS start
    with the same PREFIX tokens (their suffixes differ), so a paged engine
    with prefix sharing adopts the first one's blocks."""
    from repro_torch.serving import poisson_trace
    rng = np.random.default_rng(seed)
    arrivals = poisson_trace(n_requests, rate=0.5, seed=seed + 1)
    lens = rng.integers(32, 257, size=n_requests)
    prefix = rng.integers(0, vocab, size=PREFIX, dtype=np.int32)
    trace = []
    for i, (n, a) in enumerate(zip(lens, arrivals)):
        prompt = rng.integers(0, vocab, size=int(n), dtype=np.int32)
        if i in SHARERS:
            prompt = np.concatenate([prefix, prompt[:max(int(n) - PREFIX, 16)]])
        trace.append(dict(prompt=prompt, max_new_tokens=new_tokens,
                          arrival_time=float(a)))
    return trace


def engine_config(**kw):
    from repro_torch.serving import EngineConfig
    base = dict(arch=ARCH, reduced=False, n_slots=8, s_max=512,
                prefill_buckets=(64, 128, 256), decode_block=8)
    base.update(kw)
    return EngineConfig(**base)


PAGED = dict(kv_layout="paged", kv_block=KV_BLOCK)
PAGED_INT8 = dict(PAGED, kv_dtype="int8")


def serve(cfg, model, trace, device, draft=None, engine=None, **ec_kw):
    """Drive the trace through an Engine (``engine``: one already built,
    else one of ``engine_config(**ec_kw)``). Returns a dict with the tokens,
    counters, the admission shapes and times, decode block times, kernel
    launches, the engine's paging telemetry and its CUDA graphs (on the
    card every decode block and every admitted prompt is a replay: checked
    against the calls made). ``draft``: (cfg, model) of a speculative
    draft; then the blocks are the spec rounds (each one replay of the
    ``"spec round"`` graph) and every admitted prompt is a replay of each
    model's admission graph."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.serving import Engine
    eng = engine or Engine(engine_config(**ec_kw), cfg=cfg, params=model,
                           device=device,
                           draft_cfg=draft[0] if draft else None,
                           draft_params=draft[1] if draft else None)
    admits, admit_ms, block_ms = [], [], []
    admit, multi, single = eng._admit_step, eng._decode_multi, eng._decode
    cuda = torch.device(device).type == "cuda"
    check(isinstance(multi, ST.GraphedStep) == cuda
          and isinstance(admit, ST.GraphedAdmit) == cuda
          and (not eng.spec
               or isinstance(eng._decode_spec, ST.GraphedRound) == cuda),
          f"an engine on {device} does not take its graphs as it should")

    def timed(fn, into):
        def run(*a):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            if cuda:
                torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    timed_admit = timed(admit, admit_ms)

    def admit_logged(m, c, tokens, *rest):
        admits.append(tuple(tokens.shape))
        return timed_admit(m, c, tokens, *rest)

    if eng.spec:
        timed_admit = timed(eng._admit_spec, admit_ms)
        eng._admit_spec = lambda m, dm, c, dc, tokens, *rest: (
            admits.append(tuple(tokens.shape)),
            timed_admit(m, dm, c, dc, tokens, *rest))[1]
        eng._decode_spec = timed(eng._decode_spec, block_ms)
    eng._admit_step = admit_logged
    eng._decode_multi = timed(multi, block_ms)
    eng._decode = timed(single, block_ms)
    reqs = [eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                       arrival_time=r["arrival_time"]) for r in trace]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()            # just before the main path is driven
    t0 = time.perf_counter()
    done = eng.run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()       # just after
    routes = ops.route_launch_counts()
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
    graphs = eng.graph_stats()
    if cuda:
        step = "decode block" if eng.ec.decode_block > 1 else "decode step"
        step = "spec round" if eng.spec else step
        check(graphs[step]["replays"] == len(block_ms),
              f"{graphs[step]['replays']} replays of the {step} graph for "
              f"{len(block_ms)} blocks")
        def replays(draft):
            return sum(g["replays"] for k, g in graphs.items()
                       if k.startswith("admit ")
                       and k.startswith("admit draft ") == draft)
        for draft_model in (False, True)[:1 + eng.spec]:
            check(replays(draft_model) == sum(s[0] for s in admits),
                  f"an admitted prompt was not a replay of its pad shape's "
                  f"graph (draft model: {draft_model})")
    if eng._alloc is not None:
        eng._alloc.check_invariants()
    spec = {}
    if eng.spec:
        check(torch.equal(eng.cache["pos"], eng.cache_draft["pos"]),
              "spec: the two caches' pos differ after the trace")
        spec = dict(spec_k=eng.ec.spec_k, rounds=len(block_ms),
                    acceptance_rate=eng.acceptance_rate)
    return dict(tokens=[list(r.out_tokens) for r in reqs], counters=dict(c),
                spec=spec,
                graphs=graphs,
                admits=admits, admit_ms=admit_ms, block_ms=block_ms,
                wall_s=wall, launches=launches, routes=routes,
                n_blocks=len(block_ms),
                steps_per_block=eng.ec.spec_k if eng.spec
                else eng.ec.decode_block,
                paging_stats=eng.paging_stats,
                kv_dtype_served=eng.kv_dtype_served,
                expert_weight_dtypes=list(eng.expert_weight_dtypes()),
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9 if cuda
                         else None))


#: kernels with a tensor-core route (bf16; for the MoE pairs, at widths that
#: are multiples of 8, or 16 with int8 tables, as every served config's)
#: beside their CUDA-core one (fp32)
ROUTED = ("flash_attention", "swiglu_mlp", "gather_swiglu", "grouped_swiglu",
          "gather_swiglu_q", "grouped_swiglu_q")


def check_launches(res, n_layers: int, dispatch: str = "gather",
                   experts: str = "bf16", kv: str = "dense",
                   family: str = "moe", dtype: str = "bfloat16"):
    """Every kernel's launches in one serve: MoE family, the gather kernel of
    the expert form once per decode step and MoE layer; the grouped kernel of
    the form once per ADMITTED ROW and MoE layer (each row is prefilled
    alone), plus every decode step under ragged. Dense family, the
    swiglu_mlp kernel once per admitted row and layer plus once per decode
    step and layer, and no MoE kernel. Both: the flash kernel once per
    admitted row and layer (the admission's full-sequence attention, dense
    and paged); the paged kernel of the pool's type once per decode step and
    layer, where the dense cache's decode runs the bf16 one over a contiguous
    table; every other kernel never (qwen3-moe has no shared expert, so no
    swiglu_mlp). Each launch of a ROUTED kernel took the route of the
    model's dtype: the tensor-core kernels in bf16, the CUDA-core ones in
    fp32."""
    steps = res["n_blocks"] * res["steps_per_block"]
    rows = sum(shape[0] for shape in res["admits"])
    sfx = "_q" if experts == "int8" else ""
    used = {"flash_attention": rows * n_layers}
    if family == "dense":
        used["swiglu_mlp"] = (rows + steps) * n_layers
    else:
        used["grouped_swiglu" + sfx] = rows * n_layers + (
            steps * n_layers if dispatch == "ragged" else 0)
    if family != "dense" and dispatch == "gather":
        used["gather_swiglu" + sfx] = steps * n_layers
    used["paged_attention_q" if kv == "int8" else "paged_attention"] = \
        steps * n_layers
    want = {name: used.get(name, 0) for name in TABLE}
    check(res["launches"] == want,
          f"launches {res['launches']} != expected {want}")
    check(all(n > 0 for n in used.values()),
          f"a kernel of this form never launched: {res['launches']}")
    check_routes(res["routes"], dtype)


def check_routes(routes, dtype: str):
    """Every launch of a routed kernel took its dtype's route, every launch
    of another kernel its one CUDA-core route."""
    for name, by_route in routes.items():
        took = ("tensor_core" if name in ROUTED and dtype == "bfloat16"
                else "cuda_core")
        check(sum(n for r, n in by_route.items() if r != took) == 0,
              f"{name}: launches off the {took} route in {dtype}: "
              f"{by_route}")


def build_model(cfg, device, seed):
    from repro_torch.models import model as MD
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MD.init(cfg, device, seed=seed)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def weights_gb(model) -> float:
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def quantize(model):
    """Int8 expert tables in place (every MoE layer of both stacks)."""
    from repro_torch.core import quant as Q
    t0 = time.perf_counter()
    Q.quantize_model_experts(model)
    torch.cuda.synchronize()
    free()
    return time.perf_counter() - t0


def free():
    """Return freed tensors' memory to the card (call after ``del``)."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_summary(res, card):
    n_tok = sum(len(t) for t in res["tokens"])
    graphs = graph_summary(res["graphs"])
    return dict(card=card, requests=len(res["tokens"]), tokens=n_tok,
                wall_s=res["wall_s"], tokens_per_s=n_tok / res["wall_s"],
                # the graphs are set up at their first use, inside the run
                tokens_per_s_without_graph_setup=n_tok / (
                    res["wall_s"] - graphs["setup_s"]),
                admissions=len(res["admits"]),
                admitted_rows=sum(s[0] for s in res["admits"]),
                largest_admission=max(res["admits"], key=lambda s: s[0] * s[1]),
                ms_per_admission_median=statistics.median(res["admit_ms"]),
                decode_blocks=res["n_blocks"],
                ms_per_decode_block_median=statistics.median(res["block_ms"]),
                ms_per_decode_block_max=max(res["block_ms"]),
                peak_memory_gb=res["peak_gb"], counters=res["counters"],
                launches=res["launches"], routes=res["routes"],
                paging_stats=res["paging_stats"],
                kv_dtype_served=res["kv_dtype_served"],
                expert_weight_dtypes=res["expert_weight_dtypes"],
                finite_lane="all ones (a zero quarantines its slot)",
                cuda_graphs=graphs)


def graph_summary(graphs: dict) -> dict:
    """An engine's CUDA graphs: how many, their warm-up, capture and
    instantiate seconds (``setup_s``: the three summed), the bytes their
    captures added to the pools (``torch.cuda.memory_reserved`` around each
    capture), and each graph's own numbers."""
    sums = {k: sum(g[k] for g in graphs.values())
            for k in ("warm_up_s", "capture_s", "instantiate_s")}
    return dict(count=len(graphs), **sums, setup_s=sum(sums.values()),
                pool_bytes=sum(g["reserved_bytes"] for g in graphs.values()),
                by_graph=graphs)


def teacher_forced(cfg, model, trace, tokens, device, kv=None, **ec_kw):
    """Greedy predictions under teacher forcing, as
    benchmarks/serve_bench.py takes them for ``top1_match_int8_kv``: the
    streams ``tokens`` (a dense bf16 engine's greedy output) fed back one
    decode step at a time; entry [i][j] is the argmax before token j of
    stream i. ``kv``: None for the dense cache, else ``"bf16"`` / ``"int8"``
    for the paged pool. At the engine's own shapes (``engine_config(
    **ec_kw)``), so that a dense engine's stream reads 1.0 against itself:
    the trace goes through in groups of ``n_slots`` requests, each prompt
    admitted alone at its pad length, then every decode step runs over all
    ``n_slots`` slots (the library's products pick their algorithm by the
    number of rows)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    ec = engine_config(**ec_kw)
    n_slots, s_max = ec.n_slots, ec.s_max
    shapes = ST.admit_pad_shapes(ec.prefill_buckets, s_max)
    c = with_dispatch(cfg, "gather", n_slots)
    new = max(len(t) for t in tokens)
    nb = n_slots * s_max // KV_BLOCK
    pred = []
    for lo in range(0, len(trace), n_slots):
        group = trace[lo:lo + n_slots]
        if kv is None:
            cache = MD.init_slot_cache(c, n_slots, s_max, device)
            admit, extra = ST.make_slot_admit(c), ()
        else:
            cache = MD.init_paged_cache(c, n_slots, s_max, device, n_blocks=nb,
                                        block_size=KV_BLOCK, kv_dtype=kv)
            cache["tab"][:n_slots] = torch.arange(
                nb, dtype=torch.int32, device=device).reshape(n_slots, -1)
            admit = ST.make_slot_admit_paged(c)
            extra = (torch.zeros((1,), dtype=torch.int32, device=device),)
        forced = np.zeros((n_slots, new), np.int32)
        out = np.zeros((n_slots, new), np.int64)
        for i, r in enumerate(group):
            n = len(r["prompt"])
            toks = np.zeros((1, min(s for s in shapes if s >= n)), np.int32)
            toks[0, :n] = r["prompt"]
            _, greedy, cache = admit(
                model, cache, torch.from_numpy(toks).to(device),
                torch.tensor([n], dtype=torch.int32, device=device),
                np.array([i], np.int32), *extra)
            out[i, 0] = int(greedy[0])
            t = tokens[lo + i]
            forced[i, :len(t)] = t
        act = torch.arange(n_slots, device=device) < len(group)
        for j in range(new - 1):
            logits, cache = MD.decode_step_slots(
                c, model, cache, torch.from_numpy(forced[:, j]).to(device),
                act)
            out[:, j + 1] = torch.argmax(logits, dim=-1).cpu().numpy()
        pred.extend(list(out[i]) for i in range(len(group)))
        del cache
        free()
    return [p[:len(t)] for p, t in zip(pred, tokens)]


def top1(pred, tokens) -> float:
    """Share of positions at which two token streams agree."""
    flat = [x == y for ta, tb in zip(pred, tokens) for x, y in zip(ta, tb)]
    return sum(flat) / len(flat)


def quality(args, full_cfg, device):
    """The int8 pools' and tables' teacher-forced top-1 against the dense
    bf16 engine at the scale benchmarks/serve_bench.py gates it (the reduced
    bf16 config; requests of 8 to 32 prompt tokens and 16 new tokens on 4
    slots, s_max 64), on the card. The paged int8 pool must reach
    KV_INT8_TOLERANCE, the reference's own gate, over 128 requests (2048
    positions: a binomial standard error of 0.5 points near 0.955). The
    reading over serve_bench's default 16 requests (256 positions, 1.3
    points) is reported beside it, not gated. The dense engine's own stream
    must read 1.0 (teacher forcing at the served batch)."""
    from repro_torch.models import model as MD
    from repro_torch.serving import poisson_trace
    cfg = full_cfg.reduced()
    model = MD.init(cfg, device, seed=args.seed)
    n_requests = 128
    rng = np.random.default_rng(args.seed + 1)
    lens = rng.choice([8, 16, 24, 32], size=n_requests)
    arrivals = poisson_trace(n_requests, rate=0.5, seed=args.seed + 2)
    prompts = np.random.default_rng(0)
    trace = [dict(prompt=prompts.integers(0, cfg.vocab_size, size=int(n),
                                          dtype=np.int32),
                  max_new_tokens=16, arrival_time=float(a))
             for n, a in zip(lens, arrivals)]
    kw = dict(n_slots=4, s_max=64, prefill_buckets=(8, 16, 24, 32))
    dense = serve(cfg, model, trace, device, **kw)["tokens"]
    pred = {}
    for form, kv in (("dense", None), ("paged bf16 KV", "bf16"),
                     ("paged int8 KV", "int8")):
        pred[form] = teacher_forced(cfg, model, trace, dense, device, kv=kv,
                                    **kw)
    quantize(model)
    pred["int8 experts"] = teacher_forced(cfg, model, trace, dense, device, **kw)
    del model
    free()
    out = {form: top1(p, dense) for form, p in pred.items()}
    first_256 = {form: top1(p[:16], dense[:16]) for form, p in pred.items()}
    check(out["dense"] == 1.0, f"reduced config: the dense engine's stream "
                               f"teacher-forced at its served batch reads "
                               f"{out['dense']}, not 1.0")
    check(out["paged int8 KV"] >= KV_INT8_TOLERANCE,
          f"paged int8 KV: teacher-forced top-1 {out['paged int8 KV']} < "
          f"{KV_INT8_TOLERANCE} at the reduced config")
    return dict(config=cfg.name, dtype=cfg.dtype, tokens=sum(map(len, dense)),
                teacher_forced_top1_vs_dense=out,
                first_16_requests_256_positions=first_256,
                tolerance_paged_int8_kv=KV_INT8_TOLERANCE)


def cpu_witness(args, full_cfg, device):
    """A second witness of the paged int8 pool's full-width reading: its
    teacher-forced top-1 against the paged bf16 pool on the same contexts
    (the dense engine's streams, served on the card), taken on the card
    through the CUDA kernels and on the CPU through the plain versions, on the
    same weights at the published widths with the depth cut to
    ``--witness-layers``. Prompts of 16 to 48 tokens keep the CPU's part to
    minutes. Reported, not gated."""
    from repro_torch.models import model as MD
    from repro_torch.serving import poisson_trace
    t0 = time.perf_counter()
    cfg = full_cfg.replace(n_layers=args.witness_layers)
    cpu_model = MD.init(cfg, "cpu", seed=args.seed)
    gpu_model = MD.init(cfg, device, seed=args.seed)
    gpu_model.load_state_dict(cpu_model.state_dict())
    n_requests = 16
    rng = np.random.default_rng(args.seed + 3)
    arrivals = poisson_trace(n_requests, rate=0.5, seed=args.seed + 4)
    trace = [dict(prompt=rng.integers(0, cfg.vocab_size, size=int(n),
                                      dtype=np.int32),
                  max_new_tokens=24, arrival_time=float(a))
             for n, a in zip(rng.integers(16, 49, size=n_requests), arrivals)]
    dense = serve(cfg, gpu_model, trace, device)["tokens"]
    pred = {}
    for where, model, dev in (("card", gpu_model, device),
                              ("cpu", cpu_model, "cpu")):
        for kv in ("bf16", "int8"):
            pred[where, kv] = teacher_forced(cfg, model, trace, dense, dev,
                                             kv=kv)
    del cpu_model, gpu_model
    free()
    return dict(
        layers=cfg.n_layers, positions=sum(map(len, dense)),
        int8_pool_vs_bf16_pool_same_contexts={
            where: top1(pred[where, "int8"], pred[where, "bf16"])
            for where in ("card", "cpu")},
        vs_dense_on_the_card={f"{kv} pool, {where}": top1(pred[where, kv],
                                                          dense)
                              for where in ("card", "cpu")
                              for kv in ("bf16", "int8")},
        seconds=time.perf_counter() - t0)


#: the device kernels of the decode MoE: the gather kernels' tensor-core
#: routes (bf16 and int8 tables) with their combine, and the CUDA-core
#: kernels of moe_swiglu.cuh (the int8 gather's route before the tensor-core
#: one; in a MoE model's block nothing else runs them)
GATHER_KERNEL_NAMES = ("gather_up_tc", "gather_down_tc", "gather_up_q_tc",
                       "gather_down_q_tc", "combine_kernel",
                       "swiglu_up_kernel", "swiglu_down_kernel")


#: the paged attention kernels' namespace in csrc/paged_attention.cuh (the
#: split and combine passes, and the single kernel they replaced)
PAGED_KERNEL_TAG = "paged::"


def profile_block(cfg, model, trace, device, eager: bool = False, **ec_kw):
    """One steady decode block (8 slots busy) under torch.profiler, with the
    cache ``ec_kw`` asks for (default the dense cache), replayed from the
    engine's CUDA graph (``eager``: the same body run eagerly): host wall
    time, the device span (CUDA events around the block), the device's busy
    share (the sum of the kernels' own rows), the kernels that take the
    device time, the decode MoE's share of it (``gather_swiglu_ms``: the
    gather kernels of the model's expert tables, bf16 or int8) and the
    paged attention kernels' (``paged_attention_ms``: both passes, either
    pool type)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine
    eng = Engine(engine_config(**ec_kw), cfg=cfg, params=model, device=device)
    if eager:
        eager_steps(eng)
    for r in trace[:8]:
        eng.submit(r["prompt"], max_new_tokens=64, arrival_time=0.0)
    eng.step_block()                   # admission + one block (+ captures)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        eng.step_block()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    mode = "eager" if eager else "graph"

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    every = prof.key_averages()
    # the kernels' own rows; a CPU op's row also carries the device time of
    # the kernels it launched, so a sum over every row counts a library
    # kernel twice (that sum is kept beside as ``..._with_op_rows``)
    rows = sorted((e for e in every if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    busy_all_ms = sum(dev_us(e) for e in every) / 1e3
    n_kernels = sum(e.count for e in rows if dev_us(e) > 0)
    if busy_ms == 0.0:
        return dict(mode=mode, wall_ms=wall_ms, device_span_ms=span_ms,
                    device="not measured (the profiler saw no kernel; "
                    "device_span_ms is CUDA events around the block)")
    gather_ms = sum(dev_us(e) for e in rows
                    if any(n in e.key for n in GATHER_KERNEL_NAMES)) / 1e3
    paged = [e for e in rows if PAGED_KERNEL_TAG in e.key]
    paged_ms = sum(dev_us(e) for e in paged) / 1e3
    return dict(mode=mode, wall_ms=wall_ms, device_span_ms=span_ms,
                steps=eng.ec.decode_block, layers=cfg.n_layers,
                device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
                device_busy_ms_with_op_rows=busy_all_ms,
                device_kernels=n_kernels, gather_swiglu_ms=gather_ms,
                gather_swiglu_share_of_busy=gather_ms / busy_ms,
                paged_attention_ms=paged_ms,
                paged_attention_share_of_busy=paged_ms / busy_ms,
                paged_attention_kernels={e.key[:60]: dict(
                    count=e.count, ms=dev_us(e) / 1e3) for e in paged},
                top=[dict(name=e.key[:60], count=e.count, ms=dev_us(e) / 1e3)
                     for e in rows[:8]])


@contextlib.contextmanager
def int8_moe_route(route: str):
    """The int8 MoE pair's wrappers take ``route`` whatever ``moe_tc.route_q``
    would choose, inside the block (for tracing the route before the
    tensor-core one beside it in one run)."""
    from repro_torch.kernels import moe_tc
    chosen = moe_tc.route_q
    moe_tc.route_q = lambda dtype, d, f: route
    try:
        yield
    finally:
        moe_tc.route_q = chosen


def with_dispatch(cfg, name, B):
    """The MoE dispatch an engine of ``B`` slots serves with (a dense-family
    config has none and comes back as it is)."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, dispatch=name,
        gather_max_tokens=max(cfg.moe.gather_max_tokens, B)))


def graph_maker(device):
    """A graph factory as an engine makes one (one pool, one side stream),
    or None off the card, where the steps run eagerly."""
    from repro_torch.launch import steps as ST
    if torch.device(device).type != "cuda":
        return None
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
    return lambda: ST.CudaGraph(pool, stream)


def admission_step(cfg, model, cache, device, paged=False):
    """The engine's admission step over ``cache``: on the card each row
    replayed from its pad shape's CUDA graph (``steps.GraphedAdmit``), as
    the engine admits; elsewhere the eager builder."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    consts = MD.slot_consts(cfg, cache)
    new_graph = graph_maker(device)
    if new_graph is None:
        build = ST.make_slot_admit_paged if paged else ST.make_slot_admit
        return build(cfg, consts)
    row = (ST.admit_row_paged if paged else ST.admit_row)(cfg, consts)
    return ST.GraphedAdmit(row, model, cache, new_graph)


def decode_step(step, model, cache, device, like):
    """A decode step of launch/steps.py over ``cache``: on the card
    replayed from a CUDA graph (``steps.GraphedStep``, static buffers shaped
    like the tensors ``like``), as the engine decodes; elsewhere as it is."""
    from repro_torch.launch import steps as ST
    new_graph = graph_maker(device)
    if new_graph is None:
        return step
    return ST.GraphedStep(step, model, cache,
                          [torch.empty_like(t) for t in like], new_graph)


def admitted_cache(cfg, model, toks, lengths, device, paged=False):
    """A cache of len(toks) slots (s_max 128) holding the prompts, admitted
    through the engine's admission step (each row alone, replayed from its
    CUDA graph on the card)."""
    from repro_torch.models import model as MD
    B = toks.shape[0]
    slots = np.arange(B, dtype=np.int32)
    if not paged:
        cache = MD.init_slot_cache(cfg, B, 128, device)
        logits, _, cache = admission_step(cfg, model, cache, device)(
            model, cache, toks, lengths, slots)
        return logits, cache
    nb = B * 128 // KV_BLOCK
    cache = MD.init_paged_cache(cfg, B, 128, device, n_blocks=nb,
                                block_size=KV_BLOCK)
    cache["tab"][:B] = torch.arange(nb, dtype=torch.int32,
                                    device=device).reshape(B, -1)
    logits, _, cache = admission_step(cfg, model, cache, device, paged=True)(
        model, cache, toks, lengths, slots,
        torch.zeros((B,), dtype=torch.int32, device=device))
    return logits, cache


def host_ms(fn, rounds: int = 3) -> float:
    """Median host wall time of ``fn`` ending in a synchronize."""
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def alternating_ms(fns: dict, pairs: int) -> dict:
    """Host wall ms of each of two calls ending in a synchronize, run in
    ``pairs`` pairs whose order alternates (a b, b a, ...): the medians, the
    per-pair ratios second / first name, and every reading."""
    (na, fa), (nb, fb) = fns.items()
    ms = {na: [], nb: []}
    for i in range(pairs):
        for name, fn in ((na, fa), (nb, fb))[::1 if i % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    ratios = [b / a for a, b in zip(ms[na], ms[nb])]
    return dict(pairs=pairs, median_ms={n: statistics.median(v)
                                        for n, v in ms.items()},
                ratio_median=statistics.median(ratios),
                ratio_range=[min(ratios), max(ratios)], ms=ms)


# ---------------------------------------------------------------------------
# CUDA graphs: graph == eager, and eager against graph in time
# ---------------------------------------------------------------------------

def eager_steps(eng):
    """Swap ``eng``'s graphed steps for the same bodies run eagerly (with
    the same ``slot_consts``): the baseline of the comparisons. An engine
    on the card never does this itself."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    cfg, ec = eng.cfg, eng.ec
    consts = MD.slot_consts(cfg, eng.cache)
    admit = ST.make_slot_admit_paged if eng._alloc is not None \
        else ST.make_slot_admit
    eng._admit_step = admit(cfg, consts)
    eng._decode = ST.make_slot_decode(cfg, ec.temperature, consts)
    eng._decode_multi = ST.make_slot_decode_multi(cfg, ec.decode_block,
                                                  ec.temperature, consts)
    if eng.spec:
        dconsts = MD.slot_consts(eng.draft_cfg, eng.cache_draft)
        dual = ST.make_slot_admit_spec_paged if eng._alloc is not None \
            else ST.make_slot_admit_spec
        eng._admit_spec = dual(cfg, eng.draft_cfg, steps=(
            eng._admit_step, admit(eng.draft_cfg, dconsts)))
        eng._decode_spec = ST.make_slot_decode_spec(
            cfg, eng.draft_cfg, ec.spec_k, ec.temperature, consts, dconsts)
    eng._graphed = {}
    return eng


def recorded(eng) -> list:
    """Keep a copy of what each of ``eng``'s step calls returns (a replay's
    outputs are rewritten by the next replay): ``("admit", pad shape,
    logits, first tokens)``, ``("block", block)``, ``("step", logits,
    aux)``."""
    log = []
    admit, multi, single = eng._admit_step, eng._decode_multi, eng._decode

    def a(m, c, tokens, *rest):
        logits, greedy, c = admit(m, c, tokens, *rest)
        log.append(("admit", tuple(tokens.shape), logits.clone(),
                    greedy.clone()))
        return logits, greedy, c

    def b(*args):
        block, act, c = multi(*args)
        log.append(("block", block.clone()))
        return block, act, c

    def s(*args):
        logits, aux, c = single(*args)
        log.append(("step", logits.clone(), aux.clone()))
        return logits, aux, c
    eng._admit_step, eng._decode_multi, eng._decode = a, b, s
    if eng.spec:
        admit_spec, spec = eng._admit_spec, eng._decode_spec

        def a2(m, dm, c, dc, tokens, *rest):
            logits, greedy, c, dc = admit_spec(m, dm, c, dc, tokens, *rest)
            log.append(("admit", tuple(tokens.shape), logits.clone(),
                        greedy.clone()))
            return logits, greedy, c, dc

        def r(*args):
            block, act, c, dc = spec(*args)
            log.append(("round", block.clone()))
            return block, act, c, dc
        eng._admit_spec, eng._decode_spec = a2, r
    return log


def caches_equal(g, e, committed_only: bool = False) -> bool:
    """Two caches bitwise, a pool's sink block excepted (sentinel writes
    land there, several on one row, in no fixed order; no table entry owns
    it and no kernel reads it). ``committed_only``: a dense cache's K/V rows only below each slot's
    ``pos`` (a speculative round leaves rejected drafts past it)."""
    for name in g:
        a, b = g[name], e[name]
        if name in ("kp", "vp", "ks", "vs"):
            a, b = a[:, :-1], b[:, :-1]
        elif committed_only and name in ("k", "v"):
            keep = (torch.arange(a.shape[2], device=a.device)[None, :]
                    < g["pos"][:, None])[None, :, :, None, None]
            a, b = torch.where(keep, a, 0), torch.where(keep, b, 0)
        if not torch.equal(a, b):
            return False
    return True


def graph_vs_eager(cfg, model, trace, device, n_requests: int = 16,
                   new_tokens: int = 9, draft=None, **ec_kw) -> dict:
    """A serve form (``ec_kw``; ``draft``: a speculative draft's (cfg,
    model)) driven by two engines in lockstep: one replaying its CUDA
    graphs, one running the same bodies eagerly. After every engine step
    the whole cache (``pos``, every KV row or pool block but the sink, the
    table; a speculative engine's two caches, dense K/V rows below ``pos``)
    must be bitwise equal; at the end, every call's outputs (each admission
    group's logits and first tokens, at every pad shape the trace uses, and
    each decode block, step or round, a round's whole ``[K+1, B, 3]`` block:
    an idle slot of a paged pool reads block ``n_blocks - 1``, never the
    sink) and the tokens. With 8 slots, 16
    requests and ``new_tokens = K + 1`` each request lives one admission
    and one block."""
    from repro_torch.launch import steps as ST
    from repro_torch.serving import Engine
    engs = {mode: Engine(engine_config(**ec_kw), cfg=cfg, params=model,
                         device=device,
                         draft_cfg=draft[0] if draft else None,
                         draft_params=draft[1] if draft else None)
            for mode in ("graph", "eager")}
    eager_steps(engs["eager"])
    check(isinstance(engs["graph"]._decode_multi, ST.GraphedStep)
          and (draft is None
               or isinstance(engs["graph"]._decode_spec, ST.GraphedRound)),
          "the engine on the card does not replay graphs")
    logs = {m: recorded(e) for m, e in engs.items()}
    reqs = {m: [e.submit(r["prompt"], max_new_tokens=new_tokens,
                         arrival_time=0.0) for r in trace[:n_requests]]
            for m, e in engs.items()}
    steps = 0
    while not engs["graph"].idle:
        for e in engs.values():
            if e.spec:
                e.step_spec()
            elif e.ec.decode_block > 1:
                e.step_block()
            else:
                e.step()
        torch.cuda.synchronize()
        steps += 1
        for which in ("cache", "cache_draft"):
            g, e = (getattr(eng, which) for eng in engs.values())
            check(g is None or caches_equal(g, e, committed_only=draft
                                            is not None),
                  f"graph != eager: {which} after engine step {steps} "
                  f"({ec_kw})")
    check(engs["eager"].idle, "graph != eager: the eager engine has work left")
    check(len(logs["graph"]) == len(logs["eager"]),
          "graph != eager: another number of step calls")
    for gl, el in zip(logs["graph"], logs["eager"]):
        same = gl[0] == el[0] and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(gl[1:], el[1:]))
        check(same, f"graph != eager: the outputs of a {gl[0]} call "
                    f"({ec_kw})")
    tokens = {m: [list(r.out_tokens) for r in rs] for m, rs in reqs.items()}
    check(tokens["graph"] == tokens["eager"], "graph != eager: tokens")
    kinds = [entry[0] for entry in logs["graph"]]
    return dict(bitwise=True, engine_steps=steps,
                admission_groups=kinds.count("admit"),
                decode_calls=len(kinds) - kinds.count("admit"),
                pad_shapes=sorted({entry[1][1] for entry in logs["graph"]
                                   if entry[0] == "admit"}),
                cuda_graphs=graph_summary(engs["graph"].graph_stats()))


def graph_timings(cfg, model, trace, device, pairs: int = 10,
                  prompt_lens=(64, 128, 256), **ec_kw) -> dict:
    """Eager against graph in ``pairs`` alternating pairs in one process
    (``alternating_ms``): ms per decode block with 8 busy slots (the
    engine's ``step_block``, copies and readback included), and ms per
    admitted prompt of each length in ``prompt_lens`` (one admission call
    and its readback). Each engine first admits, captures and runs two
    blocks; both must have emitted the same tokens, and the timed
    admissions the same logits."""
    from repro_torch.serving import Engine
    engs = {}
    for mode in ("eager", "graph"):
        eng = Engine(engine_config(**ec_kw), cfg=cfg, params=model,
                     device=device)
        if mode == "eager":
            eager_steps(eng)
        reqs = [eng.submit(r["prompt"], max_new_tokens=8 * (pairs + 2) + 1,
                           arrival_time=0.0) for r in trace[:8]]
        eng.step_block()
        eng.step_block()
        engs[mode] = (eng, reqs)
    block = alternating_ms({m: e.step_block for m, (e, _) in engs.items()},
                           pairs)
    check([r.out_tokens for r in engs["graph"][1]]
          == [r.out_tokens for r in engs["eager"][1]],
          "graph != eager: tokens in the timed blocks")
    out = dict(pairs=pairs, decode_block=_with_spread(block), admission={})
    gen = torch.Generator(device=device).manual_seed(7)
    for n in prompt_lens:
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=device, dtype=torch.int32)
        lens = torch.full((1,), n, dtype=torch.int32, device=device)
        calls, logits = {}, {}
        for mode, (eng, _) in engs.items():
            extra = (torch.zeros((1,), dtype=torch.int32, device=device),) \
                if eng._alloc is not None else ()

            def call(eng=eng, extra=extra, mode=mode):
                lg, first, _ = eng._admit_step(eng.params, eng.cache, toks,
                                               lens, np.zeros((1,), np.int32),
                                               *extra)
                logits[mode] = lg.clone()
                return first.cpu()
            calls[mode] = call
            call()                                      # capture
        out["admission"][n] = _with_spread(alternating_ms(calls, pairs))
        check(torch.equal(logits["graph"], logits["eager"]),
              f"graph != eager: admission logits at {n} tokens")
    out["cuda_graphs"] = graph_summary(engs["graph"][0].graph_stats())
    return out


def _with_spread(res: dict) -> dict:
    """``alternating_ms``'s result with each mode's spread, (max - min) /
    median of its readings."""
    res["spread"] = {m: (max(v) - min(v)) / statistics.median(v)
                     for m, v in res["ms"].items()}
    return res


def prefix_hit(cfg, model, device) -> dict:
    """ROADMAP C3 on a prefix hit, under the engine's dispatch (``cfg``;
    capacity dispatch would make the row count change which tokens are
    dropped), at a shape of the serve trace: a 144-token prompt admitted
    whole (bucket 256) into slot 0 of a paged pool, then into slot 1, which
    adopts slot 0's first 128 rows and forwards its 16-row suffix padded to
    the whole prompt's bucket, as the engine does: the logits must be
    bitwise equal. Read beside it: the suffix at its own bucket (64, the
    reference's padding), the ms per admission of each in alternating pairs,
    and which products of layer 0 give a row other bits at 64 or 128 rows
    than among 256."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    from repro_torch.models.numerics import ein, ein32
    gen = torch.Generator(device=device).manual_seed(11)
    S, shared, s_max, whole_bucket, own_bucket = 144, 128, 512, 256, 64
    i32 = dict(dtype=torch.int32, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (1, whole_bucket),
                           generator=gen, device=device)
    prompt[:, S:] = 0
    mb = s_max // KV_BLOCK
    cache = MD.init_paged_cache(cfg, 2, s_max, device, n_blocks=2 * mb,
                                block_size=KV_BLOCK)
    tab = torch.arange(2 * mb, **i32).reshape(2, mb)
    tab[1, :shared // KV_BLOCK] = tab[0, :shared // KV_BLOCK]
    cache["tab"][:2] = tab
    admit = admission_step(cfg, model, cache, device, paged=True)
    whole, _, _ = admit(model, cache, prompt, torch.tensor([S], **i32),
                        np.array([0], np.int32), torch.zeros((1,), **i32))

    def hit(bucket):
        toks = torch.zeros((1, bucket), dtype=prompt.dtype, device=device)
        toks[0, :S - shared] = prompt[0, shared:S]
        return lambda: admit(model, cache, toks,
                             torch.tensor([S - shared], **i32),
                             np.array([1], np.int32),
                             torch.tensor([shared], **i32))[0]

    padded, own = hit(whole_bucket), hit(own_bucket)
    lp, lo = padded(), own()
    check(bool(torch.equal(lp, whole)),
          f"contracts: a prefix hit padded to the whole prompt's bucket "
          f"differs from the whole admission, max gap "
          f"{float((lp - whole).abs().max())} (C3)")
    timing = alternating_ms({"whole_prompt_bucket": padded,
                             "own_bucket": own}, pairs=5)
    blk = model.stack[0]
    x = L.rmsnorm(blk.ln1, L.embed_apply(model.embed, prompt), cfg.norm_eps)
    heads = torch.randn((1, whole_bucket, cfg.n_heads * cfg.hd),
                        generator=gen, device=device).to(x.dtype)
    products = {"wq": (ein, x, blk.attn.wq), "wk": (ein, x, blk.attn.wk),
                "wv": (ein, x, blk.attn.wv), "wo": (ein, heads, blk.attn.wo),
                "router (fp32)": (ein32, x, blk.moe.router)}
    rows_alike = {}
    for m in (64, 128):
        rows_alike[f"{m}_vs_{whole_bucket}"] = {
            name: bool(torch.equal(fn("bsd,dh->bsh", a, w)[:, :m],
                                   fn("bsd,dh->bsh", a[:, :m].contiguous(),
                                      w)))
            for name, (fn, a, w) in products.items()}
    del cache
    free()
    return dict(prompt=S, shared_rows=shared,
                whole_prompt_bucket_logits_bitwise=True,
                own_bucket_logits_bitwise=bool(torch.equal(lo, whole)),
                own_bucket_logits_max_abs_gap=float((lo - whole).abs().max()),
                ms_per_admission=timing, products_rows_bitwise=rows_alike)


def previous_attn_decode_slots(cfg, p, x, cache_k, cache_v, pos, *,
                               inv_freq, view=None):
    """The dense decode attention the port ran before the cache was decoded
    through the paged kernel: the plain ``_sdpa`` over every row of the
    cache. A yardstick for ``dense_decode_ab`` only (the cache must hold
    exactly ``s_max`` rows); nothing else calls it."""
    from repro_torch.models import layers as L
    B, S_max = x.shape[0], cache_k.shape[1]
    q, k, v = L._qkv(cfg, p, x)
    positions = pos[:, None]
    if inv_freq is not None:
        q = L.apply_rope(q, positions, inv_freq)
        k = L.apply_rope(k, positions, inv_freq)
    b_iota = torch.arange(B, device=x.device)
    in_range = (pos < S_max)[:, None, None]
    row = pos.clamp(max=S_max - 1).to(torch.long)
    cache_k[b_iota, row] = torch.where(in_range, k[:, 0].to(cache_k.dtype),
                                       cache_k[b_iota, row])
    cache_v[b_iota, row] = torch.where(in_range, v[:, 0].to(cache_v.dtype),
                                       cache_v[b_iota, row])
    valid = (torch.arange(S_max, device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    out = L._sdpa(q, cache_k, cache_v, valid, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return L.ein("bsh,hd->bsd", out, p.wo).to(x.dtype), cache_k, cache_v


def dense_decode_ab(cfg, model, device, lens, pairs: int = 10) -> dict:
    """One decode block (8 steps, 8 busy slots at ``lens`` rows, the
    engine's fused step) of the dense cache, its attention through the
    paged kernel over the contiguous table (the port) against the previous
    plain ``_sdpa`` over the whole cache, in alternating pairs in this
    process: everything but the attention is the same code and state."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    B, s_max = lens.shape[0], 512
    gcfg = with_dispatch(cfg, "gather", B)
    cache = MD.init_slot_cache(gcfg, B, s_max, device, block_size=KV_BLOCK)
    check(cache["k"].shape[2] == s_max, "the yardstick needs rows == s_max")
    gen = torch.Generator(device=device).manual_seed(13)
    for t in (cache["k"], cache["v"]):
        t.normal_(generator=gen)
    pos0 = lens.to(device, cache["pos"].dtype)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=device)
    act = torch.ones((B,), dtype=torch.bool, device=device)
    rem = torch.full((B,), 100, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    block = ST.make_slot_decode_multi(gcfg, 8)
    port = L.attn_decode_slots

    def run(attn):
        def fn():
            L.attn_decode_slots = attn
            try:
                cache["pos"] = pos0.clone()
                block(model, cache, tok, act, rem, eos)
            finally:
                L.attn_decode_slots = port
        return fn

    fns = {"previous_sdpa": run(previous_attn_decode_slots),
           "paged_kernel": run(port)}
    for fn in fns.values():                                 # warm up
        fn()
    out = alternating_ms(fns, pairs)
    del cache
    free()
    return dict(layers=cfg.n_layers, slots=B, steps=8, **out)


def contract_inputs(cfg, device, seed: int = 3):
    """Eight prompts of up to 64 tokens, their next tokens, all slots active;
    and the engine's dispatch for 8 slots."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B, S = 8, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=device)
    lengths = torch.randint(8, S + 1, (B,), generator=gen, device=device)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=device)
    act = torch.ones((B,), dtype=torch.bool, device=device)
    return with_dispatch(cfg, "gather", B), toks, lengths, tok, act, gen


def admission_alone_vs_group(gcfg, model, toks, lengths, device) -> bool:
    """C1: a prompt's admission logits alone and in a group of four, through
    the engine's admission step, bitwise."""
    def admit_first(n):
        return admitted_cache(gcfg, model, toks[:n], lengths[:n], device)[0][0]

    alone, among = admit_first(1), admit_first(4)
    torch.cuda.synchronize()
    admit_invariant = bool(torch.equal(alone, among))
    check(admit_invariant, "contracts: a prompt's admission logits differ "
                           "alone and in a group of four")
    return admit_invariant


def fused_vs_stepwise(gcfg, model, fresh, tok, act, K: int = 4) -> bool:
    """K fused decode steps against the same K steps driven one at a time
    through the engine's single step: the logits of every step, bitwise;
    and the same on the engine's CUDA graphs (the fused block's graph
    against K replays of the single step's): every step's token and the
    cache after the K steps, bitwise."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    B = tok.shape[0]
    seen = []
    real = MD.decode_step_slots

    def tap(*a, **kw):
        logits, cache = real(*a, **kw)
        seen.append(logits.clone())
        return logits, cache

    rem = torch.full((B,), 100, dtype=torch.int32, device=tok.device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=tok.device)
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
    check(fused_step, "contracts: fused K steps != K single steps on logits")
    # on the graphs
    device = tok.device
    fused_cache, step_cache = fresh(), fresh()
    consts = MD.slot_consts(gcfg, fused_cache)
    g_block = decode_step(ST.make_slot_decode_multi(gcfg, K, 0.0, consts),
                          model, fused_cache, device, (tok, act, rem, eos))(
        model, fused_cache, tok, act, rem, eos)[0].clone()
    g_step = decode_step(ST.make_slot_decode(gcfg, 0.0, consts), model,
                         step_cache, device, (tok, act))
    toks, t = [], tok
    for _ in range(K):
        t = g_step(model, step_cache, t, act)[1][:, 0].clone()
        toks.append(t)
    torch.cuda.synchronize()
    check(torch.equal(g_block[:, :, 0], torch.stack(toks))
          and torch.equal(g_block, block)
          and all(torch.equal(fused_cache[n], step_cache[n])
                  for n in fused_cache),
          "contracts: on the graphs, the fused block != K single steps "
          "(tokens or cache)")
    return fused_step


def paged_vs_dense(gcfg, model, toks, lengths, tok, act, lg, device) -> dict:
    """C3: the paged pool against the dense cache, admission and one decode
    step (``lg``: the dense cache's decode logits): one kernel over the same
    rows in the same blocks, bitwise; the decode step also replayed from
    the engine's CUDA graph over both layouts, bitwise each other and
    ``lg``."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    la_d, dc = admitted_cache(gcfg, model, toks, lengths, device)
    la_p, pc = admitted_cache(gcfg, model, toks, lengths, device, paged=True)
    lp, _ = MD.decode_step_slots(gcfg, model, pc, tok, act)

    def graph_logits(cache):
        step = ST.make_slot_decode(gcfg, 0.0, MD.slot_consts(gcfg, cache))
        return decode_step(step, model, cache, device, (tok, act))(
            model, cache, tok, act)[0].clone()
    # the same step on the engine's graphs, from the same admitted caches
    _, pc2 = admitted_cache(gcfg, model, toks, lengths, device, paged=True)
    lg_graph, lp_graph = graph_logits(dc), graph_logits(pc2)
    torch.cuda.synchronize()
    check(torch.equal(lp_graph, lg_graph) and torch.equal(lg_graph, lg),
          "contracts: on the graphs, paged decode logits != dense, or the "
          "graph's != the eager step's, bitwise")
    check(bool(torch.equal(la_p, la_d)),
          "contracts: paged admission logits != dense, bitwise")
    check(bool(torch.equal(lp, lg)),
          f"contracts: paged decode logits != dense, bitwise (max gap "
          f"{float((lp - lg).abs().max())})")
    return dict(admission_logits_max_abs_gap=float((la_p - la_d).abs().max()),
                decode_logits_max_abs_gap=float((lp - lg).abs().max()),
                decode_logits_bitwise=bool(torch.equal(lp, lg)),
                decode_logits_bitwise_on_graphs=True,
                decode_argmax_equal_share=float(
                    (lp.argmax(-1) == lg.argmax(-1)).float().mean()))


def contracts(cfg, model, device, lens):
    """On one cache state: logits of a decode step under gather and under
    ragged dispatch, and of K fused steps against the same K steps driven one
    at a time, compared with torch.equal; a prompt's admission logits alone
    and in a group of four (bitwise, and the time per group of the
    batch-invariant admission against the batched prefill it replaced); the
    paged pool's admission and decode logits against the dense cache's,
    bitwise, and a prefix hit's admission against the whole prompt's
    (ROADMAP C3); the dense decode block against the previous plain
    attention, timed in alternating pairs."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    gcfg, toks, lengths, tok, act, gen = contract_inputs(cfg, device)
    B = toks.shape[0]

    def fresh():
        return admitted_cache(gcfg, model, toks, lengths, device)[1]

    lg, _ = MD.decode_step_slots(gcfg, model, fresh(), tok, act)
    lr, _ = MD.decode_step_slots(with_dispatch(cfg, "ragged", B), model, fresh(),
                                 tok, act)
    check(bool(torch.isfinite(lg).all()), "contracts: non-finite logits")
    gather_ragged = bool(torch.equal(lg, lr))
    check(gather_ragged, "contracts: gather != ragged on decode logits")

    # ---- C1: admission alone and in a group of four, the engine's step
    admit_invariant = admission_alone_vs_group(gcfg, model, toks, lengths,
                                               device)
    # the batched prefill that admission ran before: not batch-invariant
    b_alone, _, _ = MD.prefill_slots(gcfg, model, toks[:1], lengths[:1])
    b_among, _, _ = MD.prefill_slots(gcfg, model, toks[:4], lengths[:4])
    batched_gap = float((b_alone[0] - b_among[0]).abs().max())
    # what the batch-1 rule costs: one group of four 256-token prompts
    t4 = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                       device=device)
    l4 = torch.full((4,), 256, dtype=torch.int32, device=device)
    cache4 = MD.init_slot_cache(gcfg, 4, 512, device)
    slots4 = np.arange(4, dtype=np.int32)
    admit_step = ST.make_slot_admit(gcfg)
    admit_graph = admission_step(gcfg, model, cache4, device)

    def batched():
        _, k, v = MD.prefill_slots(gcfg, model, t4, l4)
        MD.insert_slots(cache4, slots4, k, v, l4)

    per_row_ms = host_ms(lambda: admit_step(model, cache4, t4, l4, slots4))
    per_row_graph_ms = host_ms(
        lambda: admit_graph(model, cache4, t4, l4, slots4))
    batched_ms = host_ms(batched)
    del cache4
    free()

    fused_step = fused_vs_stepwise(gcfg, model, fresh, tok, act)
    paged = paged_vs_dense(gcfg, model, toks, lengths, tok, act, lg, device)
    hit = prefix_hit(gcfg, model, device)
    decode_ab = dense_decode_ab(cfg, model, device, lens)
    return dict(gather_vs_ragged_logits_bitwise=gather_ragged,
                fused_vs_stepwise_logits_bitwise=fused_step,
                prefill_alone_vs_in_batch_logits_bitwise=admit_invariant,
                batched_prefill_alone_vs_in_batch_max_abs_gap=batched_gap,
                admission_group_of_4x256_ms=dict(
                    batch_invariant=per_row_ms,
                    batch_invariant_on_graphs=per_row_graph_ms,
                    batched_prefill=batched_ms),
                paged_vs_dense=paged,
                prefix_hit_vs_whole_prompt=hit,
                dense_decode_block_ms=decode_ab)


#: mlp_logit_gap on an H100 80GB HBM3 at 700 W before mlp_apply set
#: round_gu (the kernel's MLP kept g and u in fp32): max |logit gap| against
#: the cuBLAS MLP and the share of rows whose argmax agreed (PERF.md §6)
EARLIER_MLP_GAP = {"admission": (0.117, 7 / 8), "decode": (0.127, 8 / 8)}


def mlp_vs_cpu_model(p, device) -> dict:
    """C6 held where the repair can be seen: granite's layer-0 MLP at full
    width on 64 rows of N(0, 1), the card's kernel with ``round_gu`` (the
    model's MLP) and with the kernel contract (g and u in fp32) against the
    model's arithmetic on the CPU (``mlp_apply`` on the same bf16 inputs):
    the share of output elements bitwise equal to the CPU's. Only the order
    of the fp32 sums differs between the card's ``round_gu`` and the CPU, so
    its share must be the larger."""
    from repro_torch.kernels import swiglu as SW
    from repro_torch.models import layers as L
    gen = torch.Generator(device=device).manual_seed(19)
    x = torch.randn((64, p.wg.shape[0]), generator=gen,
                    device=device).to(p.wg.dtype)
    cpu = types.SimpleNamespace(wg=p.wg.cpu(), wu=p.wu.cpu(), wd=p.wd.cpu())
    want = L.mlp_apply(cpu, x.cpu())
    res = {}
    for name, option in (("model_round_gu", True), ("kernel_contract", False)):
        got = SW.mlp(x, p.wg, p.wu, p.wd, round_gu=option).cpu()
        res[name] = dict(share_bitwise_equal=float((got == want).float()
                                                   .mean()),
                         max_abs_gap=float((got.float() - want.float()).abs()
                                           .max()))
    res["max_abs_y"] = float(want.float().abs().max())
    check(res["model_round_gu"]["share_bitwise_equal"]
          > res["kernel_contract"]["share_bitwise_equal"],
          f"swiglu_mlp round_gu is no closer to the CPU model than the "
          f"kernel contract: {res}")
    return res


def mlp_logit_gap(cfg, model, device) -> dict:
    """A reading, not a check: admission and decode logits with the model's
    MLP (``mlp_apply``: the swiglu_mlp kernel with ``round_gu``, g and u
    rounded to bf16) and with the kernel's own contract (g and u fp32)
    against the cuBLAS MLP it replaced (``previous_mlp_apply``: g and u
    rounded to bf16 by the library), for two sets of contract inputs, beside
    the earlier reading (``EARLIER_MLP_GAP``). With random weights a deep
    model's gap is set by the order of the fp32 sums as much as by the MLP's
    rounding; ``mlp_vs_cpu_model`` and ``round_gu_exact`` hold the repair."""
    from repro_torch.kernels import swiglu as SW
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    port = L.mlp_apply

    def contract(p, x):
        return SW.mlp(x, p.wg, p.wu, p.wd)
    res = dict(earlier_reading={
        what: dict(max_abs_gap=gap, argmax_equal_share=share)
        for what, (gap, share) in EARLIER_MLP_GAP.items()})
    for seed in (3, 29):
        gcfg, toks, lengths, tok, act, _ = contract_inputs(cfg, device, seed)
        out = {}
        for name, mlp in (("model_round_gu", port),
                          ("kernel_contract", contract),
                          ("previous_cublas", previous_mlp_apply)):
            L.mlp_apply = mlp
            try:
                la, cache = admitted_cache(gcfg, model, toks, lengths, device)
                ld, _ = MD.decode_step_slots(gcfg, model, cache, tok, act)
            finally:
                L.mlp_apply = port
            out[name] = (la, ld)
        torch.cuda.synchronize()
        res[f"inputs_seed_{seed}"] = reading = {}
        for i, what in enumerate(("admission", "decode")):
            b = out["previous_cublas"][i]
            reading[what] = rec = dict(max_abs_logit=float(b.abs().max()),
                                       rows=int(b.shape[0]))
            for name in ("model_round_gu", "kernel_contract"):
                a = out[name][i]
                rec[name] = dict(
                    max_abs_gap=float((a - b).abs().max()),
                    argmax_equal_share=float(
                        (a.argmax(-1) == b.argmax(-1)).float().mean()))
        del out
        free()
    return res


def round_gu_exact(dev) -> dict:
    """swiglu_mlp's round_gu held bitwise on the card. The inputs make every
    fp32 sum exact in any order: integer x in [1, 4], gate / up weights in
    {2..5} / 4 (g, u quarter-integers in [32, 320], not all bf16 numbers, so
    rounding them matters; silu(g) == g in fp32 for g >= 32), down weights in
    {-2..2} / 8 (y integers below 2^22). Both settings must equal the plain
    version bitwise, on both routes, and differ from each other in bf16."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swiglu as SW
    plain = ops.KERNELS["swiglu_mlp"].plain
    gen = torch.Generator(device=dev).manual_seed(23)
    T, d, f = 64, 64, 128

    def ints(shape, lo, hi, scale):
        return torch.randint(lo, hi + 1, shape, generator=gen,
                             device=dev).float() / scale
    x, wg, wu, wd = (ints((T, d), 1, 4, 1), ints((d, f), 2, 5, 4),
                     ints((d, f), 2, 5, 4), ints((f, d), -2, 2, 8))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = [t.to(dtype) for t in (x, wg, wu, wd)]
        got = {o: SW.swiglu_mlp(*args, round_gu=o) for o in (False, True)}
        want = {o: plain(*args, round_gu=o) for o in (False, True)}
        torch.cuda.synchronize()
        rec = {f"{'round_gu' if o else 'contract'}_bitwise_vs_plain": bool(
            torch.equal(got[o], want[o])) for o in (False, True)}
        rec["round_gu_changes_the_result"] = not torch.equal(got[True],
                                                             got[False])
        out[dtype_key(dtype)] = rec
        check(rec["contract_bitwise_vs_plain"]
              and rec["round_gu_bitwise_vs_plain"]
              and rec["round_gu_changes_the_result"] == (
                  dtype == torch.bfloat16),
              f"swiglu_mlp round_gu on exact sums ({dtype_key(dtype)}): {rec}")
    return out


def sampled_block_sizes(cfg, model, trace, device) -> dict:
    """At temperature > 0, decode_block=8 and decode_block=1 on a short
    staggered trace: token for token (the noise is indexed by the token's
    position, and every prompt is admitted alone). The greedy streams differ
    from the sampled ones."""
    reqs = [dict(r, max_new_tokens=16) for r in trace[:4]]
    runs = {K: serve(cfg, model, reqs, device, temperature=TEMPERATURE,
                     decode_block=K) for K in (8, 1)}
    greedy = serve(cfg, model, reqs, device)
    equal = runs[8]["tokens"] == runs[1]["tokens"]
    check(equal, f"temperature {TEMPERATURE}: decode_block=8 gives other "
                 f"tokens than decode_block=1 "
                 f"({top1(runs[8]['tokens'], runs[1]['tokens'])} agree)")
    return dict(temperature=TEMPERATURE, requests=len(reqs),
                decode_block_8_vs_1_token_equal=equal,
                share_equal_to_greedy=top1(runs[8]["tokens"],
                                           greedy["tokens"]))


def contracts_dense(cfg, model, device, trace) -> dict:
    """The dense family at full width and depth: fused K == stepwise and a
    prompt alone == in a group of four on logits, paged == dense on
    admission and decode logits, bitwise; the logit gap of the card's MLP
    against the cuBLAS MLP it replaced, and its layer-0 MLP against the CPU's
    arithmetic; decode_block=8 == 1 token for token at temperature > 0."""
    from repro_torch.models import model as MD
    gcfg, toks, lengths, tok, act, _ = contract_inputs(cfg, device)

    def fresh():
        return admitted_cache(gcfg, model, toks, lengths, device)[1]

    lg, _ = MD.decode_step_slots(gcfg, model, fresh(), tok, act)
    check(bool(torch.isfinite(lg).all()), "dense contracts: non-finite logits")
    return dict(
        fused_vs_stepwise_logits_bitwise=fused_vs_stepwise(gcfg, model, fresh,
                                                           tok, act),
        prefill_alone_vs_in_batch_logits_bitwise=admission_alone_vs_group(
            gcfg, model, toks, lengths, device),
        paged_vs_dense=paged_vs_dense(gcfg, model, toks, lengths, tok, act, lg,
                                      device),
        mlp_vs_previous_cublas_logits=mlp_logit_gap(cfg, model, device),
        mlp_layer0_vs_cpu_model=mlp_vs_cpu_model(model.stack[0].mlp, device),
        sampled=sampled_block_sizes(gcfg, model, trace, device))


def contracts_int8(cfg, model, device):
    """The int8-table model's contracts on one cache state: a decode step's
    logits under gather and under ragged dispatch, K fused steps against the
    same K steps driven one at a time, and a prompt's admission logits alone
    and in a group of four, each bitwise."""
    from repro_torch.models import model as MD
    gcfg, toks, lengths, tok, act, _ = contract_inputs(cfg, device, seed=5)
    B = toks.shape[0]

    def fresh():
        return admitted_cache(gcfg, model, toks, lengths, device)[1]
    out = {}
    for name in ("gather", "ragged"):
        out[name], _ = MD.decode_step_slots(with_dispatch(cfg, name, B), model,
                                            fresh(), tok, act)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out["gather"], out["ragged"]))
    check(bool(torch.isfinite(out["gather"]).all()),
          "int8 contracts: non-finite logits")
    check(bitwise, "int8 gather != int8 ragged on decode logits")
    return dict(int8_gather_vs_ragged_logits_bitwise=bitwise,
                int8_fused_vs_stepwise_logits_bitwise=fused_vs_stepwise(
                    gcfg, model, fresh, tok, act),
                int8_admission_alone_vs_group_of_4_bitwise=(
                    admission_alone_vs_group(gcfg, model, toks, lengths,
                                             device)))


# ---------------------------------------------------------------------------

def rehearse_config(args, small, forms, family: str, device) -> dict:
    """One reduced fp32 config served on the card and on the CPU in every
    form of ``forms`` ((name, engine keywords, expert tables, KV type)), token
    for token, with the card's launches checked. Returns the card's run of
    each form."""
    from repro_torch.models import model as MD
    trace = make_trace(small.vocab_size, args.seed)
    cpu_model = MD.init(small, "cpu", seed=args.seed)
    gpu_model = MD.init(small, device, seed=args.seed)
    gpu_model.load_state_dict(cpu_model.state_dict())
    zero = {name: 0 for name in TABLE}
    out = {}
    for form, kw, experts, kv in forms:
        if form == "int8_experts":
            quantize(cpu_model)
            quantize(gpu_model)
            for a, b in zip(cpu_model.state_dict().values(),
                            gpu_model.state_dict().values()):
                check(torch.equal(a, b.cpu()), "rehearse: int8 tables on the "
                                               "card differ from the CPU's")
        on_cpu = serve(small, cpu_model, trace, "cpu", **kw)
        on_gpu = serve(small, gpu_model, trace, device, **kw)
        check_launches(on_gpu, small.n_layers, experts=experts, kv=kv,
                       family=family, dtype=small.dtype)
        check(on_cpu["launches"] == zero, "the CPU path launched a kernel")
        check(on_gpu["tokens"] == on_cpu["tokens"],
              f"reduced fp32 {small.name}, {form}: tokens on the card differ "
              f"from the CPU's")
        check(on_gpu["admits"] == on_cpu["admits"], "admission shapes differ")
        check(on_gpu["paging_stats"] == on_cpu["paging_stats"],
              f"{form}: paging stats differ")
        if kv != "dense":
            check(on_gpu["paging_stats"]["prefix_hits"] > 0,
                  f"{form}: no prefix hit on the shared-prefix trace")
        out[form] = on_gpu
    check(out["paged"]["tokens"] == out["dense"]["tokens"],
          f"reduced fp32 {small.name} on the card: paged tokens differ from "
          f"dense")
    check(out["sampled"]["tokens"] != out["dense"]["tokens"],
          f"reduced fp32 {small.name}: the sampled streams equal the greedy "
          f"ones")
    del cpu_model, gpu_model
    free()
    return out


def rehearse(args, full_cfg, dense_cfg, device):
    """The reduced fp32 configs served on the card and on the CPU in every
    form, token for token: qwen3-moe greedy in four forms and sampled at
    TEMPERATURE, granite-8b greedy in three and sampled. Returns qwen3-moe's
    dense run on the card (its admission shapes size the kernel phase)."""
    sampled = ("sampled", dict(temperature=TEMPERATURE), "bf16", "dense")
    moe_forms = (("dense", {}, "bf16", "dense"),
                 ("paged", PAGED, "bf16", "bf16"),
                 ("paged_int8kv", PAGED_INT8, "bf16", "int8"), sampled,
                 ("int8_experts", {}, "int8", "dense"))
    small = full_cfg.reduced().replace(dtype="float32")
    out = rehearse_config(args, small, moe_forms, "moe", device)
    dense_small = dense_cfg.reduced().replace(dtype="float32")
    out_dense = rehearse_config(args, dense_small, moe_forms[:4], "dense",
                                device)
    dense = out["dense"]
    largest = max(dense["admits"], key=lambda s: s[1])
    emit("rehearse", configs=[small.name, dense_small.name],
         forms={small.name: [f[0] for f in moe_forms],
                dense_small.name: [f[0] for f in moe_forms[:4]]},
         temperature_of_sampled_forms=TEMPERATURE,
         token_equal_card_vs_cpu=True, paged_equal_dense_on_card=True,
         requests=len(dense["tokens"]), admissions=dense["admits"],
         largest_bucket=largest[1],
         grouped_rows_at_full_width=largest[1] * full_cfg.moe.top_k,
         paging_stats={f"{c.name} {f}": o[f]["paging_stats"]
                       for c, o in ((small, out), (dense_small, out_dense))
                       for f in ("paged", "paged_int8kv")},
         launches={f"{c.name} {f}": r["launches"]
                   for c, o in ((small, out), (dense_small, out_dense))
                   for f, r in o.items()})
    return dense, largest[1] * full_cfg.moe.top_k


# ---------------------------------------------------------------------------
# families: the fixed-batch server over every family
# ---------------------------------------------------------------------------

#: the families served at their published widths and full depth in the
#: families phase (granite-8b, the dense family, joins them there)
FAMILIES = ("mamba2-370m", "zamba2-2.7b", "whisper-base",
            "phi-3-vision-4.2b")
#: batch, prompt tokens and new tokens of the families phase; whisper's
#: prompt is FAMILY_AUDIO_PROMPT tokens over its n_audio_ctx frames
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 128, 32
FAMILY_AUDIO_PROMPT = 32
#: the reduced rehearsal: batch, prompt, new tokens; and the reference
#: decode-parity test's shape and tolerance (tests/test_decode_parity.py)
REHEARSE_FAMILY = (2, 8, 6)
PARITY_B, PARITY_S, PARITY_TOL = 2, 16, dict(atol=0.08, rtol=0.05)


def family_cfg(arch: str, reduced: bool = False, layers=None):
    """The config of ``arch`` as the families phase serves it: an MoE
    config with the gather dispatch (the serving one), fp32 when reduced."""
    from repro_torch import configs
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced().replace(dtype="float32")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="gather"))
    return cfg


def family_inputs(cfg, device, seed: int, batch: int, prompt: int):
    """Prompts ``[batch, prompt]`` int32 (numpy) and the family's extra
    inputs on ``device`` in the model type: zero-mean random frames (audio,
    standard normal) or patch embeddings at the token embeddings' scale
    (vlm, 0.02), drawn from ``seed`` on the host."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen).to(torch.int32).numpy()
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (torch.randn(
            (batch, cfg.vlm_num_patches, cfg.d_model), generator=gen)
            * 0.02).to(device, cfg.param_dtype)
    if cfg.family == "audio":
        extra["frames"] = torch.randn(
            (batch, cfg.n_audio_ctx, cfg.d_model), generator=gen).to(
                device, cfg.param_dtype)
    return prompts, extra


def family_batch(prompts, extra, device) -> dict:
    batch = {"tokens": torch.from_numpy(prompts).to(device)}
    batch.update({k: v.to(device) for k, v in extra.items()})
    return batch


def family_kernel_launches(cfg, new: int) -> dict:
    """Every kernel's launches in one ``FixedBatchServer.generate`` of
    ``new`` tokens (``new`` decode steps: the reference steps once more
    after the last token): the flash kernel once per self-attention layer in
    the prefill (the whole batch in one launch), and in whisper once per
    encoder layer and once per cross-attention per prefill and per step;
    the paged kernel once per self-attention layer and step (the cache's
    contiguous table); swiglu_mlp once per MLP per prefill and step (an MoE
    layer's shared experts are one); no MoE kernel but in an MoE config
    (gather per step, grouped per prefill, one per MoE layer)."""
    L_ = cfg.n_layers
    attn = {"ssm": 0, "hybrid": L_ // max(cfg.hybrid_attn_every, 1)}.get(
        cfg.family, L_)
    mlp = 0 if cfg.moe is not None else attn
    flash = attn
    if cfg.family == "audio":
        flash += L_ + L_ * (1 + new)        # encoder; cross-attention
        mlp = 2 * L_
    want = {name: 0 for name in TABLE}
    want.update(flash_attention=flash, paged_attention=attn * new,
                swiglu_mlp=mlp * (1 + new) if cfg.family != "audio"
                else L_ + L_ * (1 + new))
    if cfg.moe is not None:
        want.update(grouped_swiglu=L_, gather_swiglu=L_ * new,
                    swiglu_mlp=(L_ * (1 + new) if cfg.moe.n_shared_experts
                                else 0))
    return want


def decode_vs_forward(cfg, model, batch, prompt: int, tokens, step_logits):
    """The reference's decode == forward contract as a reading: the forward
    over the prompt and the generated tokens but the last, its logits at the
    positions the prefill and the steps sampled from, against theirs
    (``step_logits``: the prefill's then each step's, ``[B, V]`` fp32).
    Returns the largest gap and the share of positions whose argmax
    agrees."""
    from repro_torch.models import model as MD
    fed = torch.cat([batch["tokens"], tokens[:, :-1].to(
        batch["tokens"].device, batch["tokens"].dtype)], dim=1)
    full, _, _ = MD.forward(cfg, model, dict(batch, tokens=fed))
    want = full[:, prompt - 1:prompt - 1 + len(step_logits)]
    got = torch.stack(step_logits, dim=1)
    gap = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return dict(positions=int(want.shape[1]), max_logit_gap=gap,
                argmax_agreement=agree,
                max_abs_logit=float(want.abs().max()))


def fixed_batch_family(cfg, model, device, seed: int, prompt: int, new: int,
                       card) -> dict:
    """One model through ``FixedBatchServer`` at FAMILY_BATCH, on its CUDA
    graphs: a first generate (which captures them) with every kernel's
    launches counted (zeroed just before, read just after, each replay
    credited with its capture's; checked against
    :func:`family_kernel_launches` and the model dtype's routes) and the
    peak memory; a second one, which must give the same tokens, on the host
    clock (tokens/s, replays only); then the prefill timed alone and the
    decode steps replayed on the server's own tokens, both eager (``model``'s
    functions, each timed: host clock around work that ends in a
    synchronise), their logits held against the forward
    (:func:`decode_vs_forward`, a reading)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as MD
    prompts, extra = family_inputs(cfg, device, seed, FAMILY_BATCH, prompt)
    sc = SV.ServeConfig(arch=cfg.name, reduced=False, max_new_tokens=new,
                        seed=seed)
    srv = SV.FixedBatchServer(sc, cfg=cfg, model=model, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()              # just before the main path
    tokens = srv.generate(prompts, extra)
    torch.cuda.synchronize()
    launches = ops.launch_counts()         # just after
    routes = ops.route_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(tokens.shape == (FAMILY_BATCH, new)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"{cfg.name}: tokens out of range or of the wrong shape")
    want = family_kernel_launches(cfg, new)
    check(launches == want, f"{cfg.name}: launches {launches} != expected "
                            f"{want}")
    check_routes(routes, cfg.dtype)
    t0 = time.perf_counter()
    again = srv.generate(prompts, extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.array_equal(again, tokens),
          f"{cfg.name}: a second generate gave other tokens")
    batch = family_batch(prompts, extra, device)
    rows = prompt + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    prefill_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = MD.prefill(cfg, model, batch, s_max=rows + new)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t1) * 1e3)
    toks = torch.from_numpy(tokens).to(device)
    check(torch.equal(logits.argmax(-1).to(torch.int32), toks[:, 0]),
          f"{cfg.name}: the prefill's greedy token is not the server's")
    seen, step_ms = [logits], []
    for t in range(new - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = MD.decode_step(cfg, model, cache, toks[:, t])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        seen.append(logits)
    check(torch.equal(torch.stack([lg.argmax(-1) for lg in seen], 1).to(
        torch.int32), toks), f"{cfg.name}: the replayed steps' greedy tokens "
                             f"are not the server's")
    parity = decode_vs_forward(cfg, model, batch, prompt, toks, seen)
    del cache
    n_tok = FAMILY_BATCH * new
    return dict(
        model=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model, dtype=cfg.dtype, batch=FAMILY_BATCH,
        prompt_tokens=prompt, prompt_rows=rows, new_tokens=new,
        weights_gb=weights_gb(model), peak_gb=peak,
        prefill_ms=statistics.median(prefill_ms),
        step_ms=statistics.median(step_ms), step_ms_min=min(step_ms),
        step_ms_max=max(step_ms), tokens_per_s=n_tok / wall,
        generate_wall_s=wall, decode_vs_forward=parity,
        launches={k: v for k, v in launches.items() if v},
        routes={k: {r: n for r, n in v.items() if n}
                for k, v in routes.items() if sum(v.values())},
        card=card, tokens=tokens.tolist())


def profile_call(fn) -> dict:
    """``fn`` once (after its warm-up) under torch.profiler: host wall time,
    the device span (CUDA events around it), the device's busy share (the
    kernels' own rows) and the kernels that take it, the hand-written ones'
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0.0:
        return dict(wall_ms=wall_ms, device_span_ms=start.elapsed_time(end),
                    device="not measured (the profiler saw no kernel)")
    ours = [e for e in kernels if any(
        t in e.key for t in ("flash", "paged", "swiglu"))]
    return dict(wall_ms=wall_ms, device_span_ms=start.elapsed_time(end),
                device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                device_kernels=sum(e.count for e in kernels if dev_us(e) > 0),
                hand_written_ms=sum(dev_us(e) for e in ours) / 1e3,
                top=[dict(name=e.key[:60], count=e.count, ms=dev_us(e) / 1e3)
                     for e in kernels[:6]])


def profile_family_step(cfg, model, device, seed: int, prompt: int) -> dict:
    """One eager decode step of the fixed-batch path (after its prefill and
    a warm-up step) under torch.profiler (:func:`profile_call`)."""
    from repro_torch.models import model as MD
    prompts, extra = family_inputs(cfg, device, seed, FAMILY_BATCH, prompt)
    batch = family_batch(prompts, extra, device)
    rows = prompt + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    logits, cache = MD.prefill(cfg, model, batch, s_max=rows + 2)
    tok = logits.argmax(-1).to(torch.int32)
    logits, cache = MD.decode_step(cfg, model, cache, tok)
    tok = logits.argmax(-1).to(torch.int32)
    return profile_call(lambda: MD.decode_step(cfg, model, cache, tok))


def fixed_batch_graphs(cfg, model, device, seed: int, prompt: int, new: int,
                       profile: bool = False) -> dict:
    """The fixed-batch server on its CUDA graphs against the same bodies run
    eagerly (a server whose ``_new_graph`` is None: on the card only this
    comparison runs them so), FAMILY_BATCH prompts: greedy and at
    TEMPERATURE, the tokens, the prefill's logits and every step's,
    bitwise, the graphed server called twice (the first call captures, the
    second replays only); one step replay credits exactly an eager step's
    launches, by kernel and route; ms a step (10 pairs) and a prefill (3
    pairs), eager against graph, alternating; the graphs' warm-up, capture
    and instantiate seconds and pool bytes; with ``profile``, one replayed
    step under torch.profiler (busy and idle share)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as MD
    prompts, extra = family_inputs(cfg, device, seed, FAMILY_BATCH, prompt)
    sc = SV.ServeConfig(arch=cfg.name, reduced=False, max_new_tokens=new,
                        seed=seed)
    graphed = SV.FixedBatchServer(sc, cfg=cfg, model=model, device=device)
    eager = SV.FixedBatchServer(sc, cfg=cfg, model=model, device=device)
    eager._new_graph = None
    out = {}
    for temperature in (0.0, TEMPERATURE):
        for srv in (graphed, eager):
            srv.sc = dataclasses.replace(sc, temperature=temperature)
        want_logits = []
        want = eager.generate(prompts, extra, logits_out=want_logits)
        for call in ("capture", "replay"):
            got_logits = []
            got = graphed.generate(prompts, extra, logits_out=got_logits)
            same = [bool(torch.equal(a, b))
                    for a, b in zip(got_logits, want_logits)]
            check(np.array_equal(got, want) and len(same) == new + 1
                  and all(same),
                  f"{cfg.name}, T {temperature}, {call}: the graphed "
                  f"server differs from the eager bodies (tokens equal "
                  f"{np.array_equal(got, want)}, logits bitwise "
                  f"{sum(same)} of {len(same)})")
        out[f"T {temperature}"] = dict(tokens_equal=True,
                                       logits_bitwise=len(same))
    batch = family_batch(prompts, extra, device)
    rows = prompt + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    s_max = rows + new
    g = graphed._graphed_for(FAMILY_BATCH, s_max)
    tok = torch.zeros((FAMILY_BATCH,), dtype=torch.int32, device=device)
    _, cache = MD.prefill(cfg, model, batch, s_max=s_max)
    g["prefill"](model, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    MD.decode_step(cfg, model, cache, tok)
    torch.cuda.synchronize()
    eager_launches = ops.route_launch_counts()
    ops.reset_launch_counts()
    g["step"](model, g["cache"], tok)
    torch.cuda.synchronize()
    replay_launches = ops.route_launch_counts()
    check(replay_launches == eager_launches,
          f"{cfg.name}: one step replay credits {replay_launches}, an eager "
          f"step launched {eager_launches}")
    out["launches_per_step"] = {k: {r: n for r, n in v.items() if n}
                                for k, v in eager_launches.items()
                                if sum(v.values())}
    out["step_ms"] = alternating_ms(
        {"eager": lambda: MD.decode_step(cfg, model, cache, tok),
         "graph": lambda: g["step"](model, g["cache"], tok)}, pairs=10)
    out["prefill_ms"] = alternating_ms(
        {"eager": lambda: MD.prefill(cfg, model, batch, s_max=s_max),
         "graph": lambda: g["prefill"](model, batch)}, pairs=3)
    if profile:
        out["profile_graph_step"] = profile_call(
            lambda: g["step"](model, g["cache"], tok))
    out["graphs"] = graphed.graph_stats()
    del cache, g, graphed, eager
    return out


def rehearse_families(args, device) -> dict:
    """Every ARCH_IDS config reduced, fp32: ``FixedBatchServer`` greedy on
    the card against the same server on the CPU, token for token (the same
    weights: the CPU model's state copied to the card), its launches
    checked; and the reference's decode == forward contract on the card at
    its shape and tolerance (PARITY_TOL)."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as MD
    B, P, N = REHEARSE_FAMILY
    out = {}
    for arch in configs.ARCH_IDS:
        cfg = family_cfg(arch, reduced=True)
        cpu_model = MD.init(cfg, "cpu", seed=args.seed)
        gpu_model = MD.init(cfg, device, seed=args.seed)
        gpu_model.load_state_dict(cpu_model.state_dict())
        prompts, extra = family_inputs(cfg, "cpu", args.seed, B, P)
        sc = SV.ServeConfig(arch=cfg.name, max_new_tokens=N, seed=args.seed)
        on_cpu = SV.FixedBatchServer(sc, cfg=cfg, model=cpu_model,
                                     device="cpu").generate(prompts, extra)
        ops.reset_launch_counts()
        on_gpu = SV.FixedBatchServer(sc, cfg=cfg, model=gpu_model,
                                     device=device).generate(prompts, extra)
        launches = ops.launch_counts()
        check(launches == family_kernel_launches(cfg, N),
              f"reduced {cfg.name}: launches {launches}")
        check_routes(ops.route_launch_counts(), cfg.dtype)
        check(np.array_equal(on_gpu, on_cpu),
              f"reduced fp32 {cfg.name}: FixedBatchServer tokens on the card "
              f"differ from the CPU's")
        # the reference's decode == forward contract, on the card
        toks, ex = family_inputs(cfg, device, args.seed + 1, PARITY_B,
                                 PARITY_S)
        batch = family_batch(toks, ex, device)
        full, _, _ = MD.forward(cfg, gpu_model, batch)
        rows = PARITY_S - 2 + (cfg.vlm_num_patches if cfg.family == "vlm"
                               else 0)
        plog, cache = MD.prefill(cfg, gpu_model,
                                 dict(batch, tokens=batch["tokens"][:, :-2]),
                                 s_max=rows + 2)
        pairs = [(plog, full[:, PARITY_S - 3])]
        for t in (PARITY_S - 2, PARITY_S - 1):
            dlog, cache = MD.decode_step(cfg, gpu_model, cache,
                                         batch["tokens"][:, t])
            pairs.append((dlog, full[:, t]))
        gap = max(float((a - b).abs().max()) for a, b in pairs)
        check(all(bool(torch.allclose(a, b, **PARITY_TOL)) for a, b in pairs),
              f"reduced {cfg.name} on the card: decode != forward (largest "
              f"gap {gap})")
        out[cfg.name] = dict(family=cfg.family, token_equal_card_vs_cpu=True,
                             decode_vs_forward_max_gap=gap)
        del cpu_model, gpu_model
    free()
    return out


def engine_vs_server(cfg, model, device, res, seed: int) -> dict:
    """The served model's greedy tokens through the continuous-batching
    engine (FAMILY_BATCH slots, the prompts all admitted at once, each row
    replayed from its pad shape's graph, decode blocks on graphs) against
    the fixed-batch server's ``res``: the share of tokens equal."""
    prompts, _ = family_inputs(cfg, device, seed, FAMILY_BATCH,
                               res["prompt_tokens"])
    trace = [dict(prompt=p, max_new_tokens=res["new_tokens"],
                  arrival_time=0.0) for p in prompts]
    eng = serve(cfg, model, trace, device, arch=cfg.name,
                n_slots=FAMILY_BATCH,
                s_max=res["prompt_tokens"] + res["new_tokens"],
                prefill_buckets=(res["prompt_tokens"],))
    share = top1(eng["tokens"], res["tokens"])
    return dict(token_equal=eng["tokens"] == res["tokens"],
                share_of_tokens_equal=share,
                engine_tokens_per_s=sum(map(len, eng["tokens"]))
                / eng["wall_s"])


def moe_server_reading(args, cfg, model, device, card, totals) -> dict:
    """The serve phase's model through the fixed-batch server (the gather
    dispatch, FAMILY_BATCH prompts of FAMILY_PROMPT tokens) and through the
    engine: a reading, not a gate, since the router's top-k sees the row
    count (C5). Its launches go into ``totals``."""
    gcfg = family_cfg(ARCH, layers=cfg.n_layers)
    res = fixed_batch_family(gcfg, model, device, args.seed, FAMILY_PROMPT,
                             FAMILY_NEW, card)
    for name, n in res["launches"].items():
        totals[0][name] += n
    add_routes(totals[1], res["routes"])
    res["engine"] = engine_vs_server(gcfg, model, device, res, args.seed)
    del res["tokens"]
    return res


def families_phase(args, device, card, totals) -> dict:
    """The rehearsal, then each family at its published widths and full
    depth in bf16 (random weights from the seed), granite-8b's server
    against the engine, token for token. Each model's launches go into
    ``totals`` (launches, routes)."""
    from repro_torch import configs
    t0 = time.perf_counter()
    emit("families", form="rehearse, reduced fp32, card vs CPU", card=card,
         models=rehearse_families(args, device),
         seconds=time.perf_counter() - t0)
    lines = []
    for arch in FAMILIES + (DENSE,):
        cfg = family_cfg(arch)
        check(cfg.n_layers == configs.get(arch).n_layers
              and cfg.d_model == configs.get(arch).d_model,
              f"{arch}: not at its published widths and depth")
        t1 = time.perf_counter()
        model, build_s = build_model(cfg, device, args.seed)
        prompt = FAMILY_AUDIO_PROMPT if cfg.family == "audio" \
            else FAMILY_PROMPT
        res = fixed_batch_family(cfg, model, device, args.seed, prompt,
                                 FAMILY_NEW, card)
        for name, n in res["launches"].items():
            totals[0][name] += n
        add_routes(totals[1], res["routes"])
        if arch == DENSE:
            res["engine"] = engine_vs_server(cfg, model, device, res,
                                             args.seed)
            check(res["engine"]["token_equal"],
                  f"{arch}: the engine's greedy tokens differ from the "
                  f"fixed-batch server's ({res['engine']['share_of_tokens_equal']}"
                  f" equal)")
        if args.profile:
            res["profile_step"] = profile_family_step(cfg, model, device,
                                                      args.seed, prompt)
        res["graph_vs_eager"] = fixed_batch_graphs(
            cfg, model, device, args.seed, prompt, FAMILY_NEW,
            profile=args.profile)
        res.update(init_s=build_s, seconds=time.perf_counter() - t1)
        del res["tokens"]
        emit("families", **res)
        lines.append(res)
        del model
        free()
    return {r["model"]: r for r in lines}


# ---------------------------------------------------------------------------
# speculative decoding: the draft proposes, the full model verifies
# ---------------------------------------------------------------------------

#: draft proposals per round in the spec phase
SPEC_K = 4


def check_spec_launches(res, n_layers: int, draft_layers: int,
                        kv: str = "dense"):
    """Every kernel's launches in one speculative serve: per ADMITTED ROW
    the flash and the grouped kernel once per layer of either model (both
    prefill the row alone); per round the draft's SPEC_K decode steps (the
    gather kernel and the paged kernel of the pool's type once per draft
    layer and step) and the full model's one verify forward (the grouped
    kernel once per layer over all B * (SPEC_K + 1) rows, the paged kernel
    once per layer over as many query rows); nothing else, and in bf16
    only the tensor-core routes."""
    rounds = res["n_blocks"]
    rows = sum(shape[0] for shape in res["admits"])
    paged = "paged_attention_q" if kv == "int8" else "paged_attention"
    used = {"flash_attention": rows * (n_layers + draft_layers),
            "grouped_swiglu": rows * (n_layers + draft_layers)
            + rounds * n_layers,
            "gather_swiglu": rounds * SPEC_K * draft_layers,
            paged: rounds * (SPEC_K * draft_layers + n_layers)}
    want = {name: used.get(name, 0) for name in TABLE}
    check(res["launches"] == want,
          f"spec launches {res['launches']} != expected {want}")
    check(all(n > 0 for n in used.values()),
          f"spec: a kernel of this form never launched: {res['launches']}")
    check_routes(res["routes"], "bfloat16")


def spec_summary(res, plain, card) -> dict:
    """A speculative serve beside the plain engine's serve of the same
    trace and form."""
    n_tok = sum(len(t) for t in res["tokens"])
    graphs = graph_summary(res["graphs"])
    p_graphs = graph_summary(plain["graphs"])
    return dict(card=card, **res["spec"], requests=len(res["tokens"]),
                tokens=n_tok, counters=res["counters"],
                tokens_equal_plain=res["tokens"] == plain["tokens"],
                committed_tokens_per_round_per_active_slot=(
                    res["counters"]["tokens_out"] - len(res["tokens"]))
                / max(res["counters"]["tokens_drafted"] / SPEC_K, 1),
                ms_per_round_median=statistics.median(res["block_ms"]),
                ms_per_round_max=max(res["block_ms"]),
                plain_ms_per_decode_block_median=statistics.median(
                    plain["block_ms"]),
                plain_steps_per_block=plain["steps_per_block"],
                tokens_per_s=n_tok / res["wall_s"],
                plain_tokens_per_s=n_tok / plain["wall_s"],
                tokens_per_s_without_graph_setup=n_tok / (
                    res["wall_s"] - graphs["setup_s"]),
                plain_tokens_per_s_without_graph_setup=n_tok / (
                    plain["wall_s"] - p_graphs["setup_s"]),
                ms_per_admission_median=statistics.median(res["admit_ms"]),
                plain_ms_per_admission_median=statistics.median(
                    plain["admit_ms"]),
                launches=res["launches"], paging_stats=res["paging_stats"],
                cuda_graphs=graphs)


def spec_serve(cfg, model, draft, trace, device, card, forms, totals,
               plain_tokens=None, **expect) -> dict:
    """Serve ``trace`` with ``draft`` (cfg, model) at SPEC_K in each form
    ``forms`` {name: engine kwargs} beside the plain engine in the same
    form (``plain_tokens``: the plain dense engine's tokens, when they are
    known already): the tokens must be the plain engine's, every round one
    graph replay, the launch counts exact (added to ``totals``: (launches,
    routes)). ``expect``: ``acceptance`` the rate that must be read exactly.
    Returns each form's ``spec_summary``."""
    out = {}
    for form, kw in forms.items():
        plain = serve(cfg, model, trace, device, **kw)
        if plain_tokens is not None:
            check(plain["tokens"] == plain_tokens,
                  f"spec {form}: the plain engine's tokens moved")
        res = serve(cfg, model, trace, device, draft=draft, spec_k=SPEC_K,
                    **kw)
        kv = kw.get("kv_dtype", "bf16") if "kv_layout" in kw else "dense"
        check_spec_launches(res, cfg.n_layers, draft[0].n_layers, kv=kv)
        for name, n in res["launches"].items():
            totals[0][name] += n
        add_routes(totals[1], res["routes"])
        check(res["tokens"] == plain["tokens"],
              f"spec {form}: tokens differ from the plain engine's "
              f"({top1(res['tokens'], plain['tokens'])} agree)")
        if kw.get("kv_layout") == "paged" and kv == "bf16":
            check(res["paging_stats"]["prefix_hits"] > 0,
                  f"spec {form}: no prefix hit")
        if "acceptance" in expect:
            check(res["spec"]["acceptance_rate"] == expect["acceptance"],
                  f"spec {form}: acceptance {res['spec']['acceptance_rate']}"
                  f" != {expect['acceptance']}")
        out[form] = spec_summary(res, plain, card)
    return out


def spec_taps():
    """Patch the kernels a verify runs (``ops.paged_attention`` /
    ``paged_attention_q`` / ``grouped_swiglu`` / ``grouped_swiglu_q``) to
    keep the inputs and output of each one's first call; returns (the
    record, a function that undoes the patch)."""
    from repro_torch.kernels import ops
    seen, real = {}, {}
    for name in ("paged_attention", "paged_attention_q", "grouped_swiglu",
                 "grouped_swiglu_q"):
        real[name] = getattr(ops, name)

        def tap(*a, _name=name):
            out = real[_name](*a)
            seen.setdefault(_name, (a, out.clone()))
            return out
        setattr(ops, name, tap)

    def undo():
        for name, fn in real.items():
            setattr(ops, name, fn)
    return seen, undo


def hold_verify_kernels(seen: dict) -> dict:
    """Each kernel's first call inside a verify forward (B * (SPEC_K + 1)
    rows; per-row ``lens`` for the paged kernels) against its plain version
    on the same inputs widened to fp32, with the kernels phase's
    tolerances."""
    from repro_torch.kernels import ops
    out = {}
    for name, (a, got) in seen.items():
        plain = ops.KERNELS[name].plain
        if name.startswith("paged"):
            q, rest = a[0], a[1:]
            pools = [t.float() if t.dtype == torch.bfloat16 else t
                     for t in rest[:-2]]
            want = plain(q.float(), *pools, *rest[-2:])
            vmax = (float(rest[1].float().abs().max()) if name ==
                    "paged_attention" else float(rest[3].abs().max() * 127))
            tol = attn_tol_for(got.dtype, want, vmax)
            rows, extra = q.shape[0], dict(lens=[int(a[-1].min()),
                                                 int(a[-1].max())])
        elif name == "grouped_swiglu":
            x, wg, wu, wd, gs = a
            want = plain(x.float(), wg.float(), wu.float(), wd.float(), gs)
            tol, rows, extra = moe_tol32(want), x.shape[0], {}
        else:
            x, qt, gs = a
            want = plain(x, qt, gs)
            tol, rows, extra = moe_tol_q(want), x.shape[0], {}
        err, words = compare(f"{name} in a verify forward", got, want,
                             got.dtype, tol=tol)
        out[name] = dict(rows=rows, max_abs_err=err, tolerance=words, **extra)
    return out


def verify_vs_decode(cfg, model, device) -> dict:
    """``model.verify_step_slots`` over ``[t0, d_1..d_K]`` (K = SPEC_K)
    against K + 1 ``decode_step_slots`` calls fed the same tokens, from the
    same admitted cache of 8 slots, in each layout (the dense cache with a
    spec engine's lookahead rows, the paged pool in bf16 and int8): the
    logits of every position and the whole cache after (every K/V row and
    pool block but the sink), bitwise. The verify's kernels are held to
    their plain versions on the way (``hold_verify_kernels``)."""
    from repro_torch.models import model as MD
    gcfg, toks, lengths, tok, act, gen = contract_inputs(cfg, device, seed=9)
    B, s_max = toks.shape[0], 128
    drafts = torch.randint(0, cfg.vocab_size, (B, SPEC_K), generator=gen,
                           device=device)
    vtok = torch.cat([tok[:, None], drafts], dim=1).to(torch.int32)
    out = {}
    for layout, kv in (("dense", None), ("paged bf16", "bf16"),
                       ("paged int8", "int8")):
        if kv is None:
            cache = MD.init_slot_cache(gcfg, B, s_max, device,
                                       block_size=KV_BLOCK,
                                       lookahead=SPEC_K + 1)
            extra = ()
        else:
            nb = B * s_max // KV_BLOCK
            cache = MD.init_paged_cache(gcfg, B, s_max, device, n_blocks=nb,
                                        block_size=KV_BLOCK, kv_dtype=kv)
            cache["tab"][:B] = torch.arange(nb, dtype=torch.int32,
                                            device=device).reshape(B, -1)
            extra = (torch.zeros((B,), dtype=torch.int32, device=device),)
        admission_step(gcfg, model, cache, device, paged=kv is not None)(
            model, cache, toks, lengths, np.arange(B, dtype=np.int32), *extra)
        ver = {n: t.clone() for n, t in cache.items()}
        dec = {n: t.clone() for n, t in cache.items()}
        seen, undo = spec_taps()
        try:
            vl, _ = MD.verify_step_slots(gcfg, model, ver, vtok)
        finally:
            undo()
        dl = torch.stack([MD.decode_step_slots(gcfg, model, dec, vtok[:, t],
                                               act)[0]
                          for t in range(SPEC_K + 1)], dim=1)
        torch.cuda.synchronize()
        logits_ok = bool(torch.equal(vl, dl))
        kv_ok = all(torch.equal(ver[n][:, :-1], dec[n][:, :-1])
                    if n in ("kp", "vp", "ks", "vs") else torch.equal(
                        ver[n], dec[n])
                    for n in ver if n not in ("pos", "s_max", "kv_block"))
        check(logits_ok, f"verify != {SPEC_K + 1} decode steps on logits "
                         f"({layout}), max gap {float((vl - dl).abs().max())}")
        check(kv_ok, f"verify != {SPEC_K + 1} decode steps on the K/V rows "
                     f"({layout})")
        out[layout] = dict(logits_bitwise=logits_ok, kv_rows_bitwise=kv_ok,
                           kernels_vs_plain=hold_verify_kernels(seen))
        del ver, dec, cache
        free()
    return out


def verify_cost(cfg, model, device) -> dict:
    """Device ms (``graph_ms``) of one verify forward over SPEC_K + 1
    positions and of one decode step, 8 busy slots, dense cache, the same
    admitted prompts: the full model's share of a round beside a plain
    step (the verify runs its glue once per position block, its kernels
    once over all rows)."""
    from repro_torch.models import model as MD
    gcfg, toks, lengths, tok, act, gen = contract_inputs(cfg, device, seed=9)
    B = toks.shape[0]
    cache = MD.init_slot_cache(gcfg, B, 128, device, block_size=KV_BLOCK,
                               lookahead=SPEC_K + 1)
    admission_step(gcfg, model, cache, device)(
        model, cache, toks, lengths, np.arange(B, dtype=np.int32))
    consts = MD.slot_consts(gcfg, cache)
    vtok = torch.randint(0, cfg.vocab_size, (B, SPEC_K + 1), generator=gen,
                         device=device, dtype=torch.int32)
    pos = cache["pos"].clone()

    def verify():
        MD.verify_step_slots(gcfg, model, cache, vtok, consts)

    def step():
        MD.decode_step_slots(gcfg, model, cache, tok, act, consts)
        cache["pos"].copy_(pos)
    v_ms, s_ms = graph_ms(verify, calls=3), graph_ms(step, calls=3)
    del cache
    free()
    return dict(verify_ms=v_ms, decode_step_ms=s_ms,
                verify_over_step=v_ms / s_ms, positions=SPEC_K + 1)


def rows_decode_vs_verify(cfg, model, device, B: int) -> dict:
    """A reading, not a check: one layer's glue operations and the LM head
    on the same inputs, as B decode rows (``[B, 1, d]``, a decode step's
    call) and as the rows of a verify laid out the reference's way (``[B,
    SPEC_K + 1, d]``, in one call): for each operation in the layer's
    order, whether every decode row is bitwise its verify row, and the
    first that is not. The port's verify runs each of these per position
    block, at the decode step's shape, whatever this reads."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MO
    from repro_torch.models.numerics import ein, ein32
    gen = torch.Generator(device=device).manual_seed(17)
    T, d = SPEC_K + 1, cfg.d_model
    blk = model.stacks()[0][0]
    dt = cfg.param_dtype
    x = torch.randn((B, T, d), generator=gen, device=device).to(dt)
    heads = torch.randn((B, T, cfg.n_heads * cfg.hd), generator=gen,
                        device=device).to(dt)
    xn = L.rmsnorm(blk.ln2, x, cfg.norm_eps)
    r32 = ein32("...d,de->...e", xn, blk.moe.router)
    top = MO._topk_iterative(r32, cfg.moe.top_k)[0]
    ops_ = [("rmsnorm", lambda a: L.rmsnorm(blk.ln1, a, cfg.norm_eps), x),
            ("wq (bf16)", lambda a: ein("bsd,dh->bsh", a, blk.attn.wq), x),
            ("wk (bf16)", lambda a: ein("bsd,dh->bsh", a, blk.attn.wk), x),
            ("wv (bf16)", lambda a: ein("bsd,dh->bsh", a, blk.attn.wv), x),
            ("wo (bf16)", lambda a: ein("bsh,hd->bsd", a, blk.attn.wo), heads),
            ("router (fp32)",
             lambda a: ein32("...d,de->...e", a, blk.moe.router), xn),
            ("top-k", lambda a: torch.stack(
                MO._topk_iterative(a, cfg.moe.top_k), dim=0).float(), r32),
            ("softmax over k", lambda a: torch.softmax(a, dim=-1), top),
            ("lm_head (fp32 out)",
             lambda a: L.lm_head(cfg, model.embed, a), x)]
    alike = {}
    for name, fn, a in ops_:
        whole = fn(a)
        alike[name] = all(
            bool(torch.equal(whole.select(-2, t),
                             fn(a[:, t:t + 1].contiguous()).select(-2, 0)))
            for t in range(T))
    torch.cuda.synchronize()
    first = next((n for n, ok in alike.items() if not ok), None)
    return dict(decode_rows=B, verify_rows=B * T, rows_bitwise=alike,
                first_operation_with_other_bits=first)


def spec_self_and_adversarial(cfg, model, trace, device, card, plain_tokens,
                              totals, seed) -> dict:
    """At the serve phase's depth: the trace served with the model as its
    own draft (its own cache; acceptance must read exactly 1.0) and with a
    2-layer random model at the same widths (acceptance near 0, heavy
    rollback), both token for token the plain dense engine
    (``plain_tokens``); the function-level verify == decode, the verify's
    cost beside a decode step and the row counts reading (8 slots against
    their verify's 40 rows, 64 against 320) on the same model."""
    adv_cfg = cfg.replace(n_layers=2)
    adv, _ = build_model(adv_cfg, device, seed + 1)
    out = dict(
        layers=cfg.n_layers,
        self_draft=spec_serve(cfg, model, (cfg, model), trace, device, card,
                              {"dense cache": {}}, totals,
                              plain_tokens=plain_tokens, acceptance=1.0),
        adversarial_draft=spec_serve(cfg, model, (adv_cfg, adv), trace,
                                     device, card, {"dense cache": {}},
                                     totals, plain_tokens=plain_tokens),
        verify_vs_decode=verify_vs_decode(cfg, model, device),
        verify_cost=verify_cost(cfg, model, device),
        rows_decode_vs_verify=[rows_decode_vs_verify(cfg, model, device, B)
                               for B in (8, 64)])
    adv_rate = out["adversarial_draft"]["dense cache"]["acceptance_rate"]
    check(adv_rate < 0.25, f"spec: a random draft accepted {adv_rate}")
    del adv
    free()
    return out


def spec_merged(cfg, model, ncfg, nmodel, trace, device, card,
                totals) -> dict:
    """The compress phase's pair: the MergeMoE model drafts for the model
    it was merged from, on the serve trace, dense cache greedy and at
    temperature 0.7, paged bf16 pool with prefix hits, paged int8 pool;
    then graph == eager on the round in the dense and the paged int8
    forms."""
    forms = {"dense cache": {},
             f"dense cache, temperature {TEMPERATURE}":
                 dict(temperature=TEMPERATURE),
             "paged bf16 KV": PAGED, "paged int8 KV": PAGED_INT8}
    out = dict(layers=cfg.n_layers, draft=dict(
        merged_layers=[ncfg.moe_split, ncfg.n_layers],
        merged_experts=ncfg.moe_merged),
        forms=spec_serve(cfg, model, (ncfg, nmodel), trace, device, card,
                         forms, totals))
    out["graph_equals_eager"] = {
        form: graph_vs_eager(cfg, model, trace, device, n_requests=8,
                             draft=(ncfg, nmodel), spec_k=SPEC_K, **kw)
        for form, kw in (("dense cache", {}), ("paged int8 KV", PAGED_INT8))}
    return out


# ---------------------------------------------------------------------------
# training: the trainer on the card, its model handed to compression
# ---------------------------------------------------------------------------

#: the full-width train phase (qwen3-moe at COMPRESS_LAYERS layers, the
#: config's remat "full" and capacity dispatch, AdamW at the trainer's lr,
#: grads rounded to bf16): steps, global batch, sequence length
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 64, 8, 256
#: the last loss must sit at least this far below the first (nats)
TRAIN_LOSS_DROP = 1.0
#: the reduced fp32 rehearsal: steps, learning rate, batch x sequence
REHEARSE_STEPS, REHEARSE_LR, REHEARSE_SHAPE = 5, 1e-3, (4, 32)
#: card against CPU, fp32: losses relative; parameters absolute, a tenth of
#: the learning rate (AdamW moves a parameter by about lr * sign(g) where
#: |g| is near its eps, so a gradient of 1e-8 summed in another order moves
#: that parameter by a part of lr)
REHEARSE_LOSS_RTOL, REHEARSE_PARAM_ATOL = 1e-4, 0.1 * REHEARSE_LR
#: the resume drill: k steps, a checkpoint, a fresh trainer, k more
RESUME_K = 2


def rehearse_train_config(**kw):
    from repro_torch.launch import train as LT
    return LT.TrainConfig(**{**dict(global_batch=REHEARSE_SHAPE[0],
                                    seq_len=REHEARSE_SHAPE[1],
                                    lr=REHEARSE_LR, log_every=10 ** 6,
                                    dtype="float32"), **kw})


def flat_leaves(tree, prefix="") -> dict:
    """A reference-layout tree (nested dicts) as {dotted name: tensor}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def leaf_gaps(want: dict, got: dict) -> dict:
    """{leaf: max |want - got|} over the leaves that are not bitwise equal
    (int leaves must be equal: a gap there is inf)."""
    gaps = {}
    for name, a in want.items():
        a, b = a.detach().cpu(), got[name].detach().cpu()
        if torch.equal(a, b):
            continue
        gaps[name] = (float((a.double() - b.double()).abs().max())
                      if a.is_floating_point() else float("inf"))
    return gaps


def model_leaves(model) -> dict:
    from repro_torch import convert
    return flat_leaves(convert.reference_tree(model))


def train_card_vs_cpu(arch: str, device) -> dict:
    """The trainer (``launch.train.train``) on the reduced fp32 config, the
    same REHEARSE_STEPS steps on the card and on the CPU from the same
    weights: a step-0 checkpoint of the CPU's initialisation (a generator
    on the card draws other numbers), which each trainer resumes. Losses
    and every parameter within the stated tolerances."""
    from repro_torch import convert
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.data.pipeline import DataState
    from repro_torch.launch import train as LT
    root = tempfile.mkdtemp(prefix="train_rehearse_",
                            dir=tempfile.gettempdir())
    atexit.register(shutil.rmtree, root, True)
    _, model, state, _ = LT.build(rehearse_train_config(arch=arch,
                                                        device="cpu"))
    CKPT.save(f"{root}/init", 0, (convert.reference_tree(model), state),
              {"data_state": DataState().to_json()})
    del model, state
    runs = []
    for i, dev in enumerate(("cpu", device)):
        shutil.copytree(f"{root}/init", f"{root}/run{i}")
        runs.append(LT.train(rehearse_train_config(
            arch=arch, steps=REHEARSE_STEPS, device=dev,
            ckpt_dir=f"{root}/run{i}", ckpt_every=10 ** 6)))
    shutil.rmtree(root)
    cpu, card = runs
    loss_gap = max(abs(a - b) / abs(a)
                   for a, b in zip(cpu["losses"], card["losses"]))
    gaps = leaf_gaps(model_leaves(cpu["params"]), model_leaves(card["params"]))
    worst = max(gaps.values(), default=0.0)
    check(all(np.isfinite(card["losses"])), f"train {arch}: non-finite loss")
    check(loss_gap <= REHEARSE_LOSS_RTOL,
          f"train {arch}: card losses {card['losses']} against the CPU's "
          f"{cpu['losses']} (relative gap {loss_gap})")
    check(worst <= REHEARSE_PARAM_ATOL,
          f"train {arch}: a parameter {worst} off the CPU's after "
          f"{REHEARSE_STEPS} steps: {gaps}")
    n = len(model_leaves(cpu["params"]))
    return dict(steps=REHEARSE_STEPS, losses_card=card["losses"],
                losses_cpu=cpu["losses"], max_loss_rel_gap=loss_gap,
                max_param_abs_gap=worst, leaves=n,
                leaves_bitwise_equal=n - len(gaps))


def resume_drill(device) -> dict:
    """RESUME_K steps, the trainer's checkpoint to a temporary directory, a
    fresh trainer resuming it for RESUME_K more, against 2 * RESUME_K
    straight, on the card under ``torch.use_deterministic_algorithms(True)``
    (reduced fp32 qwen3-moe): losses, every parameter and every optimizer
    state leaf, bitwise where they are; the ones that are not are named
    with their gap, and must sit within the rehearsal's tolerance."""
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.launch import train as LT
    root = tempfile.gettempdir()
    check(shutil.disk_usage(root).free > 1e9,
          f"train: the resume drill wants 1 GB free in {root}")
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=root)
    atexit.register(shutil.rmtree, root, True)
    k = RESUME_K
    torch.use_deterministic_algorithms(True)
    try:
        straight = LT.train(rehearse_train_config(
            steps=2 * k, device=device, ckpt_dir=f"{root}/a", ckpt_every=k))
        first = LT.train(rehearse_train_config(
            steps=k, device=device, ckpt_dir=f"{root}/b", ckpt_every=k))
        rest = LT.train(rehearse_train_config(
            steps=2 * k, device=device, ckpt_dir=f"{root}/b", ckpt_every=k))
    finally:
        torch.use_deterministic_algorithms(False)
    resumed = first["losses"] + rest["losses"]
    params = leaf_gaps(model_leaves(straight["params"]),
                       model_leaves(rest["params"]))
    sa = CKPT.load(f"{root}/a", device="cpu")[0][1]
    sb = CKPT.load(f"{root}/b", device="cpu")[0][1]
    state = leaf_gaps(flat_leaves(sa), flat_leaves(sb))
    shutil.rmtree(root)
    loss_gap = max(abs(a - b) / abs(a) for a, b in zip(straight["losses"],
                                                       resumed))
    check(len(resumed) == 2 * k and loss_gap <= REHEARSE_LOSS_RTOL,
          f"train: resumed losses {resumed} against straight "
          f"{straight['losses']}")
    check(max(params.values(), default=0.0) <= REHEARSE_PARAM_ATOL,
          f"train: resumed parameters off the straight run's: {params}")
    return dict(k=k, deterministic_algorithms=True,
                bitwise=(straight["losses"] == resumed and not params
                         and not state),
                losses_straight=straight["losses"], losses_resumed=resumed,
                differing_param_leaves=params,
                differing_state_leaves=state)


#: the four families trained at their published widths and depth (bf16,
#: each config's remat, AdamW at the trainer's lr, gradients in bf16):
#: steps of SyntheticLM(seed) at TRAIN_BATCH x TRAIN_SEQ, with the family's
#: seeded patches (vlm) or frames (audio)
TRAIN_FAMILY_STEPS = 32


def family_train_cfg(arch: str, reduced: bool):
    """``arch`` as the train phase trains it: the published config, or the
    reduced one in fp32 (zamba2 at 4 layers: two segments of its shared
    block)."""
    from repro_torch import configs
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced().replace(dtype="float32")
        if cfg.family == "hybrid":
            cfg = cfg.replace(n_layers=4)
    return cfg


def family_train_batches(cfg, steps: int, batch: int, seq: int, seed: int,
                         device):
    """``steps`` train batches on ``device``, made one at a time on the
    host: SyntheticLM(seed) tokens and the family's seeded inputs (patches
    at the token embeddings' scale, standard normal frames, as
    :func:`family_inputs`), in the model type."""
    from repro_torch.data.pipeline import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for _ in range(steps):
        b = {"tokens": torch.from_numpy(next(data)["tokens"]).to(
            device, torch.int64)}
        if cfg.family == "vlm":
            b["patches"] = (torch.randn(
                (batch, cfg.vlm_num_patches, cfg.d_model), generator=gen)
                * 0.02).to(device, cfg.param_dtype)
        if cfg.family == "audio":
            b["frames"] = torch.randn(
                (batch, cfg.n_audio_ctx, cfg.d_model), generator=gen).to(
                    device, cfg.param_dtype)
        yield b


def _copy_tree(dst, src) -> None:
    """Copy a tree of tensors (nested dicts) into another of its shape."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


#: AdamW's b1, b2 and eps (``optim.adamw``'s defaults, the trainer's)
ADAMW_B1, ADAMW_B2, ADAMW_EPS = 0.9, 0.95, 1e-8
#: below this bias-corrected sqrt(v), a difference in a gradient's last bits
#: moves AdamW's normalised update m / (sqrt(v) + eps) by a part of one
NEAR_EPS = 10 * ADAMW_EPS


def adamw_floor(states: list) -> dict:
    """{parameter: the least bias-corrected sqrt(v) of each element over
    ``states`` (flat optimizer states on the host, one after each step)}."""
    out = {}
    for t, st in enumerate(states):
        for name, v in st.items():
            if name.endswith(".v"):
                x = (v.double() / (1 - ADAMW_B2 ** (t + 1))).sqrt()
                key = name[:-len(".v")]
                out[key] = torch.minimum(out[key], x) if key in out else x
    return out


def adamw_readings(states: list, name: str, idx: tuple) -> dict:
    """An element's clipped gradient and the bias-corrected sqrt(v) AdamW
    divided it by, step by step, read back from the optimizer state after
    each step: ``g_t = (m_t - b1 m_{t-1}) / (1 - b1)``."""
    g, root, m_last = [], [], 0.0
    for t, st in enumerate(states):
        m, v = float(st[name + ".m"][idx]), float(st[name + ".v"][idx])
        g.append((m - ADAMW_B1 * m_last) / (1 - ADAMW_B1))
        root.append((v / (1 - ADAMW_B2 ** (t + 1))) ** 0.5)
        m_last = m
    return dict(clipped_g=g, sqrt_v_hat=root)


def straight_param_gaps(want: dict, got: dict, want_states: list,
                        got_states: list, atol: float) -> dict:
    """Two straight AdamW runs' parameters: the largest gap of the elements
    whose sqrt(v) never fell below NEAR_EPS on either side (``far``) and of
    those whose did (``near``: AdamW's eps decides a part of their lr), and
    each element past ``atol`` with its readings on both sides."""
    floor_w, floor_g = adamw_floor(want_states), adamw_floor(got_states)
    far = near = 0.0
    past = {}
    for name, a in want.items():
        gap = (a.detach().cpu().double()
               - got[name].detach().cpu().double()).abs()
        mask = (torch.minimum(floor_w[name], floor_g[name]) < NEAR_EPS
                if name in floor_w else torch.zeros_like(gap, dtype=bool))
        far = max(far, float(gap[~mask].max()) if (~mask).any() else 0.0)
        near = max(near, float(gap[mask].max()) if mask.any() else 0.0)
        for idx in (gap > atol).nonzero().tolist()[:4]:
            idx = tuple(idx)
            past[f"{name}{list(idx)}"] = dict(
                gap=float(gap[idx]), near_eps=bool(mask[idx]), eps=ADAMW_EPS,
                **({"card": adamw_readings(got_states, name, idx),
                    "cpu": adamw_readings(want_states, name, idx)}
                   if name in floor_w else {}))
    return dict(far=far, near=near, past_atol=past)


def train_family_card_vs_cpu(arch: str, device, seed: int) -> dict:
    """The train step (``launch.steps.make_train_step``, AdamW at
    REHEARSE_LR, the trainer's bf16 gradients) on the family's reduced fp32
    config (:func:`family_train_cfg`), REHEARSE_STEPS steps on the card and
    on the CPU from the same weights (the CPU's initialisation copied to the
    card) and batches (patches or frames included). Each step on the card
    starts from the CPU's parameters and optimizer state after the step
    before: its loss within REHEARSE_LOSS_RTOL and every parameter after it
    within REHEARSE_PARAM_ATOL of the CPU's. Then the same steps run
    straight on each device: every loss within REHEARSE_LOSS_RTOL; every
    parameter within REHEARSE_PARAM_ATOL but those whose sqrt(v) fell below
    NEAR_EPS at some step on either device, where AdamW turns a difference
    in a gradient's last bits into a part of lr (those within the most two
    AdamW runs can part, 2 lr a step); each parameter past the tolerance
    reported with its clipped gradient and sqrt(v) step by step on both
    devices, beside eps. The trainer itself feeds token batches only (the
    audio family it refuses, ROADMAP C13), so the step is driven here."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MD
    from repro_torch.optim import make_optimizer
    cfg = family_train_cfg(arch, reduced=True)
    batches = list(family_train_batches(cfg, REHEARSE_STEPS, *REHEARSE_SHAPE,
                                        seed, "cpu"))

    def trainer(dev):
        model = MD.init(cfg, dev, seed=seed)
        opt = make_optimizer("adamw", lr=REHEARSE_LR)
        return [model, opt.init(MD.shape_tree(model)),
                ST.make_train_step(cfg, opt)]

    def step(t, i, dev):
        t[0], t[1], loss, _ = t[2](t[0], t[1], {k: v.to(dev) for k, v in
                                               batches[i].items()}, i)
        return float(loss)

    # each step on the card from the CPU's state after the step before
    cpu, card = trainer("cpu"), trainer(device)
    losses, loss_gap, worst, gaps = [], 0.0, 0.0, {}
    for i in range(REHEARSE_STEPS):
        card[0].load_state_dict(cpu[0].state_dict())
        _copy_tree(card[1], cpu[1])
        a, b = step(cpu, i, "cpu"), step(card, i, device)
        losses.append(b)
        loss_gap = max(loss_gap, abs(a - b) / abs(a))
        gaps = leaf_gaps(model_leaves(cpu[0]), model_leaves(card[0]))
        worst = max(worst, max(gaps.values(), default=0.0))
    check(all(np.isfinite(losses)), f"train {arch}: non-finite loss {losses}")
    check(loss_gap <= REHEARSE_LOSS_RTOL,
          f"train {arch}: a card step's loss {loss_gap} (relative) off the "
          f"CPU's from the same state")
    check(worst <= REHEARSE_PARAM_ATOL,
          f"train {arch}: a parameter {worst} off the CPU's after one step "
          f"from the same state: {gaps}")
    # straight runs
    init = MD.init(cfg, "cpu", seed=seed).state_dict()
    straight = []
    for dev in ("cpu", device):
        t = trainer(dev)
        t[0].load_state_dict(init)
        run, states = [], []
        for i in range(REHEARSE_STEPS):
            run.append(step(t, i, dev))
            states.append({k: v.detach().cpu().clone()
                           for k, v in flat_leaves(t[1]).items()})
        straight.append((run, model_leaves(t[0]), states))
    (sc, sc_params, sc_states), (sg, sg_params, sg_states) = straight
    s_loss_gap = max(abs(a - b) / abs(a) for a, b in zip(sc, sg))
    check(s_loss_gap <= REHEARSE_LOSS_RTOL,
          f"train {arch}: straight card losses {sg} against the CPU's {sc}")
    s_gaps = straight_param_gaps(sc_params, sg_params, sc_states, sg_states,
                                 REHEARSE_PARAM_ATOL)
    check(s_gaps["far"] <= REHEARSE_PARAM_ATOL,
          f"train {arch}: straight, a parameter {s_gaps['far']} off the "
          f"CPU's away from AdamW's eps: {s_gaps['past_atol']}")
    check(s_gaps["near"] <= 2 * REHEARSE_LR * REHEARSE_STEPS,
          f"train {arch}: straight, a parameter near AdamW's eps "
          f"{s_gaps['near']} off the CPU's")
    n = len(model_leaves(cpu[0]))
    return dict(family=cfg.family, layers=cfg.n_layers, steps=REHEARSE_STEPS,
                batch=REHEARSE_SHAPE, losses_card=losses,
                per_step=dict(max_loss_rel_gap=loss_gap,
                              max_param_abs_gap=worst, leaves=n,
                              leaves_bitwise_equal_after_last=n - len(gaps)),
                straight=dict(losses_card=sg, losses_cpu=sc,
                              max_loss_rel_gap=s_loss_gap,
                              max_param_abs_gap_far=s_gaps["far"],
                              max_param_abs_gap_near_eps=s_gaps["near"],
                              near_eps=NEAR_EPS,
                              past_atol=s_gaps["past_atol"]))


def train_family_full_width(arch: str, device, card, seed: int) -> dict:
    """The train step at ``arch``'s published widths and depth, bf16, its
    config's remat, AdamW at the trainer's lr, gradients in bf16:
    TRAIN_FAMILY_STEPS steps of :func:`family_train_batches` at TRAIN_BATCH
    x TRAIN_SEQ. Every loss finite, the last TRAIN_LOSS_DROP below the
    first, no hand-written kernel launched; ms a step, tokens/s, peak
    memory."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as LT
    from repro_torch.models import model as MD
    from repro_torch.optim import make_optimizer
    cfg = family_train_cfg(arch, reduced=False)
    pub = configs.get(arch)
    check(cfg.d_model == pub.d_model and cfg.d_ff == pub.d_ff
          and cfg.vocab_size == pub.vocab_size,
          f"train {arch}: not at its published widths")
    free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MD.init(cfg, device, seed=seed)
    lr = LT.TrainConfig.lr
    opt = make_optimizer("adamw", lr=lr)
    state = opt.init(MD.shape_tree(model))
    step = ST.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    losses, step_s = [], []
    for i, b in enumerate(family_train_batches(
            cfg, TRAIN_FAMILY_STEPS, TRAIN_BATCH, TRAIN_SEQ, seed, device)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, state, loss, _ = step(model, state, b, i)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t1)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    del model, state, step
    free()
    check(all(n == 0 for n in launches.values()),
          f"train {arch}: hand-written kernels launched during the steps: "
          f"{launches}")
    check(all(np.isfinite(losses)), f"train {arch}: non-finite loss {losses}")
    check(losses[-1] <= losses[0] - TRAIN_LOSS_DROP,
          f"train {arch}: the last loss {losses[-1]} is not "
          f"{TRAIN_LOSS_DROP} below the first {losses[0]}")
    steady = step_s[1:]
    rows = TRAIN_SEQ + (cfg.vlm_num_patches if cfg.family == "vlm" else 0)
    return dict(
        card=card, model=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model,
        dtype=cfg.dtype, remat=cfg.remat, optimizer="adamw", lr=lr,
        grad_dtype="bfloat16", params=n_params, steps=TRAIN_FAMILY_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, rows_per_sequence=rows,
        extra_inputs={"vlm": f"{cfg.vlm_num_patches} patches",
                      "audio": f"{cfg.n_audio_ctx} frames"}.get(cfg.family),
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        ms_per_step_median=1e3 * statistics.median(steady),
        ms_per_step_min=1e3 * min(steady), ms_first_step=1e3 * step_s[0],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(steady),
        peak_allocated_gb=peak / 1e9, launches=launches, init_s=init_s,
        seconds_total=time.perf_counter() - t0)


def train_full_width(args, full_cfg, device, card):
    """``launch.train.train`` at qwen3-moe's published widths, depth
    COMPRESS_LAYERS: TRAIN_STEPS AdamW steps on SyntheticLM(seed) batches of
    TRAIN_BATCH x TRAIN_SEQ. Every loss finite, the last TRAIN_LOSS_DROP
    below the first, no hand-written kernel launched (the training
    arithmetic is the reference's plain one). Returns (cfg, the trained
    model, frozen, its line); the optimizer state and the gradients are
    gone with the trainer."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = LT.train(LT.TrainConfig(
        arch=ARCH, reduced=False, layers=COMPRESS_LAYERS, steps=TRAIN_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, optimizer="adamw",
        device=device, seed=args.seed, log_every=16))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg, model, losses = out["cfg"], out["params"], out["losses"]
    check(cfg == full_cfg.replace(n_layers=COMPRESS_LAYERS)
          and cfg.remat == "full" and cfg.moe.dispatch == "dense",
          "the train phase trains the compress phase's config")
    check(all(n == 0 for n in launches.values()),
          f"train: hand-written kernels launched during the steps: "
          f"{launches}")
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(losses[-1] <= losses[0] - TRAIN_LOSS_DROP,
          f"train: the last loss {losses[-1]} is not {TRAIN_LOSS_DROP} "
          f"below the first {losses[0]}")
    steady = out["step_s"][1:]
    line = dict(
        card=card, model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
        remat=cfg.remat, dispatch=cfg.moe.dispatch, optimizer="adamw",
        grad_dtype="bfloat16", params=sum(p.numel()
                                          for p in model.parameters()),
        steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        ms_per_step_median=1e3 * statistics.median(steady),
        ms_per_step_min=1e3 * min(steady), ms_first_step=1e3 * out["step_s"][0],
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / statistics.median(steady),
        peak_allocated_gb=peak / 1e9, launches=launches,
        seconds_total=wall)
    del out
    free()
    return cfg, model, line


def heldout_losses(cfg, model, ncfg, nmodel, device, seed) -> dict:
    """The held-out loss of the full and the merged model on a SyntheticLM
    batch the trainer never drew (its stream at step 10**6, the training
    shape)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as LT
    from repro_torch.models import model as MD
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    data._state.step = 10 ** 6
    batch = LT.to_device(next(data), device)
    return dict(full=float(MD.loss(cfg, model, batch)[0]),
                merged=float(MD.loss(ncfg, nmodel, batch)[0]))


# ---------------------------------------------------------------------------
# MergeMoE compression at full width
# ---------------------------------------------------------------------------

def host_rss_gb() -> float:
    """Peak resident memory of this process on the host so far."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def in_sample_errors(model, nmodel, stream, layer: int, device) -> dict:
    """MergeMoE against M-SMoE on the first merged layer's card-captured
    calibration inputs, both clustered by weights (tests/test_system.py of
    the reference). MergeMoE's tables and clusters are the compressed
    model's own (its first suffix layer, as served); M-SMoE's are solved
    here on the host and rounded to the same type the same way (fp64, fp32,
    model type). Then the sum over clusters of ||merged expert(X) - sum_j
    w_j expert_j(X)||_F in fp64 on the card. MergeMoE's down projection is
    the least-squares optimum of exactly that (the two share the averaged
    gate and up tables), so up to the tables' rounding its error cannot
    exceed M-SMoE's."""
    import torch.nn.functional as F
    from repro_torch.core import clustering as CL
    from repro_torch.core import merge as MG
    orig, merged = model.stack[layer].moe, nmodel.stack_c[0].moe
    M = int(merged.live)
    tabs = [t.detach().float().cpu().numpy() for t in (orig.wg, orig.wu, orig.wd)]
    calib = stream.layer(layer)
    t0 = time.perf_counter()
    ms = MG.merge_layer("msmoe", *tabs, calib.counts, calib.x, M)
    t_solve = time.perf_counter() - t0
    assign = merged.remap.cpu().numpy()
    X = torch.from_numpy(calib.x).to(device, torch.float64)
    W = [torch.from_numpy(a).to(device, torch.float64) for a in tabs]

    def as_served(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, merged.wg.dtype)

    runs = {"mergemoe": (assign, [t[:M] for t in (merged.wg, merged.wu,
                                                  merged.wd)]),
            "msmoe": (ms.assign, [as_served(t) for t in (ms.wg, ms.wu,
                                                         ms.wd)])}

    def expert(g, u, d):
        return (F.silu(X @ g) * (X @ u)) @ d

    err = {}
    for m, (a, tables) in runs.items():
        w = CL.merge_weights(a, calib.counts, M)
        total = 0.0
        for c in range(M):
            members = np.where(a == c)[0]
            Z = sum(float(w[j]) * expert(W[0][j], W[1][j], W[2][j])
                    for j in members)
            Y = expert(*(t[c].to(torch.float64) for t in tables))
            total += float(torch.linalg.norm(Y - Z))
        err[m] = total
    del X, W
    free()
    check(err["mergemoe"] <= err["msmoe"],
          f"MergeMoE's in-sample error {err['mergemoe']} exceeds M-SMoE's "
          f"{err['msmoe']} on layer {layer}")
    return dict(layer=layer, tokens=int(calib.x.shape[0]),
                tables=str(merged.wg.dtype).replace("torch.", ""),
                in_sample_error=err,
                mergemoe_over_msmoe=err["mergemoe"] / err["msmoe"],
                same_clusters=bool(np.array_equal(assign, ms.assign)),
                msmoe_host_solve_s=t_solve)


# ---------------------------------------------------------------------------
# checkpoints: the compressed artifact stored, loaded and served
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_calls(module, name: str, into: list):
    """Append the seconds of every call of ``module.name`` made inside the
    block to ``into``."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def artifact_dir(need: int) -> str:
    """A new temporary directory with room for an artifact of ``need``
    bytes; raises, naming the need and the free space, where there is
    not."""
    root = tempfile.gettempdir()
    free_b = shutil.disk_usage(root).free
    check(free_b > need, f"ckpt: an artifact needs about {need / 1e9:.2f} GB "
                         f"and {root} has {free_b / 1e9:.2f} GB free")
    return tempfile.mkdtemp(prefix="artifact_", dir=root)


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def model_tensors(model) -> dict:
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def artifact_check(directory, ncfg, nmodel, want_tokens, trace, device, card,
                   save_s: float) -> dict:
    """``Engine.from_checkpoint(directory)`` against the in-memory model:
    every parameter and buffer ``torch.equal``, then the trace served, token
    for token ``want_tokens`` (the in-memory model's), launch counts exact.
    Returns the artifact's entry of the ``ckpt`` line."""
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.serving import Engine
    load_s = []
    with timed_calls(CKPT, "load_compressed", load_s):
        eng = Engine.from_checkpoint(directory, ec=engine_config(),
                                     device=device)
    got, want = model_tensors(eng.params), model_tensors(nmodel)
    check(got.keys() == want.keys(),
          f"ckpt: the loaded model's tensors {sorted(got.keys() ^ want.keys())}")
    for name, t in want.items():
        check(got[name].dtype == t.dtype and torch.equal(got[name], t),
              f"ckpt: {name} loaded != in memory")
    check(eng.artifact["config"] == ncfg.to_json_dict(),
          "ckpt: the artifact's config is not the compressed model's")
    experts = eng.expert_weight_dtypes()
    res = serve(eng.cfg, eng.params, trace, device, engine=eng)
    del eng
    free()
    check(res["tokens"] == want_tokens,
          f"ckpt: the loaded artifact's tokens differ from the in-memory "
          f"model's ({top1(res['tokens'], want_tokens)} agree)")
    check_launches(res, ncfg.n_layers,
                   experts="int8" if "int8" in experts else "bf16")
    disk = dir_bytes(directory)
    return dict(card=card, bytes_on_disk=disk,
                leaves=len(list(Path(directory).rglob("leaf_*.npy"))),
                expert_weight_dtypes=list(experts),
                save_s=save_s, load_s=load_s[0],
                save_gb_per_s=disk / save_s / 1e9,
                load_gb_per_s=disk / load_s[0] / 1e9,
                tensors_equal=len(want), tokens_equal_in_memory=True,
                serve=serve_summary(res, card))


def spec_from_artifact(cfg, model, ncfg, directory, trace, device, card,
                       totals, in_process: dict) -> dict:
    """The full model served with ``EngineConfig(spec_draft=directory)``,
    dense cache, greedy: tokens equal to the plain engine's, acceptance and
    the drafted / accepted / rolled-back counters equal to the in-process
    draft's (``in_process``: its spec_summary, same form)."""
    plain = serve(cfg, model, trace, device)
    res = serve(cfg, model, trace, device, spec_draft=directory,
                spec_k=SPEC_K)
    check_spec_launches(res, cfg.n_layers, ncfg.n_layers)
    for name, n in res["launches"].items():
        totals[0][name] += n
    add_routes(totals[1], res["routes"])
    check(res["tokens"] == plain["tokens"],
          "ckpt: spec_draft tokens differ from the plain engine's")
    keys = ("tokens_drafted", "tokens_accepted", "tokens_rolled_back")
    check(res["spec"]["acceptance_rate"] == in_process["acceptance_rate"]
          and all(res["counters"][k] == in_process["counters"][k]
                  for k in keys),
          f"ckpt: spec_draft acceptance {res['spec']['acceptance_rate']} != "
          f"the in-process draft's {in_process['acceptance_rate']}")
    return dict(**spec_summary(res, plain, card),
                acceptance_equal_in_process=True)


def trained_c4(cfg, model, trace, device) -> dict:
    """C4 on trained weights, a reading with no gate: the paged int8 pool's
    teacher-forced top-1 against the dense bf16 engine (whose own stream
    must read 1.0), on ``trace``."""
    dense = serve(cfg, model, trace, device)
    out = {form: top1(teacher_forced(cfg, model, trace, dense["tokens"],
                                     device, kv=kv), dense["tokens"])
           for form, kv in (("dense", None), ("paged int8 KV", "int8"))}
    check(out["dense"] == 1.0, f"trained model: the dense engine's stream "
                               f"teacher-forced reads {out['dense']}, not 1.0")
    return dict(requests=len(trace), tokens=sum(map(len, dense["tokens"])),
                teacher_forced_top1_vs_dense=out)


def compress_phase(args, full_cfg, device, card, trace, cfg, handoff):
    """The compression entry point at full width, on the train phase's
    model (``cfg``; ``handoff``: a list holding the trained, frozen model,
    popped here so that this phase holds its only reference and frees it
    as it did its own random one): calibration captured on the card (``CalibrationStream`` over the model's forward with the
    config's own capacity dispatch, the flash kernel in every layer), the
    suffix merged 128 -> 64 by ``launch.compress.run`` (fp64 host solves),
    held-out loss of both models; the in-sample check on the first merged
    layer; the compressed model served in bf16, then drafting for the model
    it was merged from (``spec_merged``, its ``spec`` line), then served
    with int8 tables; the ``ckpt`` line: each of the two stored,
    loaded and served (``artifact_check``), and the bf16 one drafting from
    its directory (``spec_from_artifact``). On the trained weights it also
    reads the held-out loss of both models on a SyntheticLM batch beside
    the uniform-token one, and C4 (``trained_c4``). Returns the launches of
    the compression run and of the serves, by kernel and by kernel and
    route."""
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.core import calibration as CAL
    from repro_torch.kernels import ops
    from repro_torch.launch import compress as LC
    model = handoff.pop()
    split = COMPRESS_SPLIT
    M = full_cfg.moe.n_experts // 2
    check(cfg == full_cfg.replace(n_layers=COMPRESS_LAYERS),
          "the compression phase's config")
    check(cfg.moe.dispatch == "dense",
          "the compression phase calibrates with the config's own dispatch")
    # the bf16 artifact takes at most 4 bytes a parameter of the full model
    # (bf16 leaves are fp32 .npy files); the int8 one is written after it
    # is deleted
    need = 4 * sum(t.numel() for t in model_tensors(model).values())
    art_root = artifact_dir(need)
    atexit.register(shutil.rmtree, art_root, True)
    dirs = {form: os.path.join(art_root, form) for form in ("bf16", "int8")}
    free_disk = shutil.disk_usage(art_root).free
    save_s = []
    calib = LC.make_batches(cfg, CALIB_BATCHES, device, CALIB_BATCH,
                            CALIB_SEQ, args.seed + 100)
    check(CALIB_BATCHES * CALIB_BATCH * CALIB_SEQ > full_cfg.moe.d_ff_expert,
          "the least squares need more calibration tokens than f")
    torch.cuda.synchronize()
    ops.reset_launch_counts()            # just before the main path
    t0 = time.perf_counter()
    stream = CAL.CalibrationStream(cfg, model).consume(calib)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timed_calls(CKPT, "save_compressed", save_s):
        ncfg, nmodel, report = LC.run(
            cfg=cfg, model=model, merged_experts=M, split=split,
            eval_batches=EVAL_BATCHES, batch=CALIB_BATCH, seq=CALIB_SEQ,
            seed=args.seed, stream=stream, device=device,
            save_dir=dirs["bf16"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = ops.launch_counts()       # just after
    routes = ops.route_launch_counts()
    check_routes(routes, cfg.dtype)
    n_forwards = CALIB_BATCHES + 2 * EVAL_BATCHES
    want = {name: 0 for name in TABLE}
    want["flash_attention"] = n_forwards * cfg.n_layers
    check(launches == want, f"compression launches {launches} != {want} "
                            f"(one flash launch per layer and forward)")
    check(all(np.isfinite(report[k]) for k in ("loss_full",
                                               "loss_compressed")),
          f"non-finite loss: {report}")
    check(ncfg.moe_merged == M and ncfg.moe_split == split
          and len(nmodel.stack_c) == cfg.n_layers - split,
          "the compressed model's layout")
    check(all(int(b.moe.remap.max()) < M for b in nmodel.stack_c),
          "a remap entry past the merged tables")
    insample = in_sample_errors(model, nmodel, stream, split, device)
    rss = host_rss_gb()
    del stream
    free()
    heldout = dict(uniform_tokens=dict(full=report["loss_full"],
                                       merged=report["loss_compressed"]),
                   synthetic_lm=heldout_losses(cfg, model, ncfg, nmodel,
                                               device, args.seed))
    c4 = trained_c4(cfg, model, trace[:COMPRESS_REQUESTS], device)
    # the compressed model served: bf16, then (after it drafted for the
    # full model) int8 tables
    served = {}
    weights = weights_gb(nmodel)
    spec_totals = ({name: 0 for name in TABLE},
                   {name: dict.fromkeys(r, 0)
                    for name, r in ops.route_launch_counts().items()})
    ckpt = {}
    for form in ("bf16", "int8"):
        if form == "int8":
            t0 = time.perf_counter()
            merged_spec = spec_merged(cfg, model, ncfg, nmodel,
                                      trace[:COMPRESS_REQUESTS], device, card,
                                      spec_totals)
            emit("spec", model=cfg.name, pair="MergeMoE draft", card=card,
                 **merged_spec, seconds=time.perf_counter() - t0)
            ckpt["spec_draft"] = spec_from_artifact(
                cfg, model, ncfg, dirs["bf16"], trace[:COMPRESS_REQUESTS],
                device, card, spec_totals,
                merged_spec["forms"]["dense cache"])
            shutil.rmtree(dirs["bf16"])
            del model
            free()
            q_s = quantize(nmodel)
            with timed_calls(CKPT, "save_compressed", save_s):
                CKPT.save_compressed(
                    dirs["int8"], ncfg, nmodel,
                    report={"experts": "int8 in every MoE layer "
                                       "(quantize_model_experts after the "
                                       "merge)"})
        serve(ncfg, nmodel, trace[:2], device)
        res = serve(ncfg, nmodel, trace[:COMPRESS_REQUESTS], device)
        check_launches(res, ncfg.n_layers, experts=form)
        served[form] = dict(weights_gb=weights if form == "bf16"
                            else weights_gb(nmodel),
                            quantize_s=q_s if form == "int8" else None,
                            **serve_summary(res, card))
        ckpt[form] = artifact_check(dirs[form], ncfg, nmodel, res["tokens"],
                                    trace[:COMPRESS_REQUESTS], device, card,
                                    save_s[-1])
    shutil.rmtree(art_root)
    del nmodel
    free()
    emit("ckpt", card=card, model=cfg.name, layers=cfg.n_layers,
         merged_layers=report["layers_merged"], merged_experts=M,
         directory_free_bytes_before=free_disk, **ckpt)
    emit("compress", card=card, model=cfg.name, layers=cfg.n_layers,
         merged_layers=report["layers_merged"], n_experts=report["n_experts"],
         merged_experts=M, calib_tokens=report["calib_tokens"],
         calib_shape=[CALIB_BATCHES, CALIB_BATCH, CALIB_SEQ],
         weights="trained (the train phase)",
         seconds=dict(capture=t_capture,
                      solve=report["t_merge_s"],
                      compress_total=report["t_total_s"],
                      eval_full=report["t_eval_base_s"],
                      eval_compressed=report["t_eval_compressed_s"],
                      run=t_run, total=t_capture + t_run,
                      save_artifact_in_run=save_s[0]),
         loss_full=report["loss_full"],
         loss_compressed=report["loss_compressed"],
         bytes_original=report["bytes_original"],
         bytes_compressed=report["bytes_compressed"],
         compression_ratio=report["compression_ratio"],
         heldout_loss=heldout, c4_trained=c4,
         spec_acceptance={form: r["acceptance_rate"] for form, r in
                          merged_spec["forms"].items()},
         peak_host_rss_gb=rss, launches=launches, in_sample=insample,
         served=served)
    total = dict(launches)
    for res in [*served.values(), ckpt["bf16"]["serve"],
                ckpt["int8"]["serve"]]:
        for name, n in res["launches"].items():
            total[name] += n
        add_routes(routes, res["routes"])
    for name, n in spec_totals[0].items():
        total[name] += n
    add_routes(routes, spec_totals[1])
    return total, routes


def add_routes(into, routes):
    for name, by_route in routes.items():
        for r, n in by_route.items():
            into[name][r] += n


def graph_check(cfg, model, trace, device, form: str, **kw) -> None:
    """Emit one form's ``graph_vs_eager`` (which raises on any difference)."""
    emit("graphs", model=cfg.name, form=form, layers=cfg.n_layers,
         graph_equals_eager=graph_vs_eager(cfg, model, trace, device, **kw))


def decode_lens(trace) -> torch.Tensor:
    """Valid rows of 8 busy slots half-way through their 32 new tokens."""
    return torch.tensor([len(r["prompt"]) + 16 for r in trace[:8]],
                        dtype=torch.int32)


# ---------------------------------------------------------------------------
# resilience: fault plans, quarantine, retries, snapshots on the graphs
# ---------------------------------------------------------------------------

#: the resilience phase's forms at --variant-layers: (name, engine keywords,
#: the model drafting for itself)
RESILIENCE_FORMS = (("paged bf16 KV", PAGED, False),
                    ("paged int8 KV", PAGED_INT8, False),
                    ("spec, self draft, dense cache", dict(spec_k=SPEC_K),
                     True))
#: the step from which the NaN plan may fire, and the snapshot's
RESILIENCE_POISON_STEP, RESILIENCE_SNAPSHOT_STEP = 16, 24
#: the drill child (tests/_torch_snapshot_drill_child.py) dies after this
DRILL_KILL_STEPS = 12


def resilience_engine(cfg, model, device, spec: bool, faults=None, **kw):
    from repro_torch.serving import Engine
    return Engine(engine_config(**kw), cfg=cfg, params=model, device=device,
                  draft_cfg=cfg if spec else None,
                  draft_params=model if spec else None, faults=faults)


def submit_trace(eng, trace) -> list:
    return [eng.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                       arrival_time=r["arrival_time"]) for r in trace]


def advance(eng):
    return eng.step_spec() if eng.spec else eng.step_block()


def advance_to(eng, step: int) -> None:
    """Step the engine until its clock reaches ``step`` with a slot
    decoding."""
    while not eng.idle and (eng.steps < step or not eng._active.any()):
        advance(eng)
    check(not eng.idle, f"the trace drained before step {step}")


@contextlib.contextmanager
def counting_captures():
    """Every ``steps.StepGraph`` built (one per graph captured) inside the
    block, in a list."""
    from repro_torch.launch import steps as ST
    seen, init = [], ST.StepGraph.__init__

    def counted(self, *a, **kw):
        init(self, *a, **kw)
        seen.append(self)
    ST.StepGraph.__init__ = counted
    try:
        yield seen
    finally:
        ST.StepGraph.__init__ = init


def uid_tokens(reqs) -> dict:
    return {r.uid: [int(t) for t in r.out_tokens] for r in reqs}


def mid_trace(cfg, model, device, spec, kw, trace):
    """An engine with the trace submitted, stepped to
    RESILIENCE_SNAPSHOT_STEP: (engine, its requests, the tokens of those
    already finished)."""
    eng = resilience_engine(cfg, model, device, spec, **kw)
    reqs = submit_trace(eng, trace)
    advance_to(eng, RESILIENCE_SNAPSHOT_STEP)
    return eng, reqs, uid_tokens(r for r in reqs if r.status != "queued")


def check_one_capture_each(eng, seen, what: str) -> None:
    """The engine's graphs were each captured once: as many captures as
    graphs, one decode-kind graph."""
    stats = eng.graph_stats()
    kind = "spec round" if eng.spec else "decode block"
    check([k for k in stats if not k.startswith("admit")] == [kind],
          f"{what}: decode graphs {sorted(stats)}")
    check(len(seen) == len(stats),
          f"{what}: {len(seen)} captures for {len(stats)} graphs")


def quarantine_check(cfg, model, device, trace, spec, kw, clean, form,
                     seed) -> dict:
    """A seeded nan_logits plan on the first slot decoding at
    RESILIENCE_POISON_STEP: that request ends failed_numeric with a prefix
    of its clean tokens, every other request's tokens are bitwise the clean
    run's, and the poison buffer recaptured nothing."""
    from repro_torch.serving import FaultPlan, FaultSpec
    eng = resilience_engine(cfg, model, device, spec, **kw)
    reqs = submit_trace(eng, trace)
    with counting_captures() as seen:
        advance_to(eng, RESILIENCE_POISON_STEP)
        slot = int(np.flatnonzero(eng._active)[0])
        victim = eng._slot_req[slot]
        plan = FaultPlan(seed=seed, specs=(FaultSpec(
            site="decode", kind="nan_logits", steps=(eng.steps,),
            slots=(slot,)),))
        eng._faults = plan
        eng.run()
    got = uid_tokens(reqs)
    check(victim.status == "failed_numeric"
          and victim.finish_reason == "numeric",
          f"{form}: the poisoned request ended {victim.status}")
    n = len(victim.out_tokens)
    check(n < victim.max_new_tokens and got[victim.uid] == clean[victim.uid][:n],
          f"{form}: the quarantined request's tokens are not a prefix of "
          f"its clean ones")
    others = [r for r in reqs if r is not victim]
    check(all(r.status == "ok" for r in others)
          and all(got[r.uid] == clean[r.uid] for r in others),
          f"{form}: a healthy request's tokens differ from the clean run's")
    check(eng.counters["quarantined"] == 1
          and plan.counts() == {"nan_logits": 1},
          f"{form}: quarantined {eng.counters['quarantined']}, plan "
          f"{plan.counts()}")
    check_one_capture_each(eng, seen, form + ", NaN plan")
    if eng._alloc is not None:
        eng._alloc.check_invariants()
    return dict(poisoned_slot=slot, step=plan.trace[0]["step"],
                tokens_kept=n, healthy_requests_bitwise=len(others),
                trace_digest=plan.trace_digest())


def retry_checks(cfg, model, device, trace, spec, kw, clean, form,
                 seed) -> dict:
    """Transient failures on every decode and admission call within
    ``device_retries`` (2): the clean tokens, every injected failure
    retried; three a call: DeviceStepError after the budget."""
    from repro_torch.core import errors as ERR
    from repro_torch.serving import FaultPlan, FaultSpec
    plan = FaultPlan(seed=seed, specs=(
        FaultSpec(site="decode", kind="transient", p=1.0, fails=2),
        FaultSpec(site="admit", kind="transient", p=1.0, fails=1)))
    eng = resilience_engine(cfg, model, device, spec, faults=plan, **kw)
    reqs = submit_trace(eng, trace)
    eng.run()
    injected = sum(ev["fails"] for ev in plan.trace)
    check(uid_tokens(reqs) == clean,
          f"{form}: retried calls gave other tokens than the clean run")
    check(eng.counters["transient_retries"] == injected > 0,
          f"{form}: {eng.counters['transient_retries']} retries for "
          f"{injected} injected failures")
    over = FaultPlan(seed=seed, specs=(
        FaultSpec(site="decode", kind="transient", p=1.0, fails=3),))
    eng = resilience_engine(cfg, model, device, spec, faults=over, **kw)
    submit_trace(eng, trace)
    raised = None
    try:
        eng.run()
    except ERR.DeviceStepError as e:
        raised = str(e)
    check(raised is not None and "device_retries=2" in raised
          and eng.counters["transient_retries"] == 2,
          f"{form}: three failures a call did not exhaust the budget of 2 "
          f"({raised})")
    return dict(within_budget_retries=injected, beyond_budget=raised)


def snapshot_check(cfg, model, device, trace, spec, kw, clean, form):
    """snapshot() at RESILIENCE_SNAPSHOT_STEP restored into a fresh engine
    on its own graphs finishes token for token, so does the engine that
    kept running, and the snapshot loaded in place into that engine (its
    graphs already captured) finishes again with no capture. Returns (the
    line's entry, the snapshot)."""
    from repro_torch.serving import Engine
    a, reqs, done_before = mid_trace(cfg, model, device, spec, kw, trace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = a.snapshot()
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = Engine.restore(snap, cfg=cfg, params=model,
                       draft_cfg=cfg if spec else None,
                       draft_params=model if spec else None, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ptrs = {n: t.data_ptr() for n, t in b.cache.items()}
    with counting_captures() as seen:
        after = uid_tokens(b.run())
    check({**done_before, **after} == clean,
          f"{form}: the restored engine's tokens differ from the "
          f"uninterrupted run's")
    check({n: t.data_ptr() for n, t in b.cache.items()} == ptrs,
          f"{form}: the restored engine rebound a cache tensor")
    check_one_capture_each(b, seen, form + ", restored")
    a.run()
    check(uid_tokens(reqs) == clean,
          f"{form}: snapshotting perturbed the engine that kept running")
    with counting_captures() as seen:
        a._load_snapshot(snap)
        again = uid_tokens(a.run())
    check({**done_before, **again} == clean and not seen,
          f"{form}: the snapshot loaded into the running engine gave other "
          f"tokens or captured {len(seen)} graphs")
    n_bytes = sum(t.numel() * t.element_size() for c in snap["arrays"].values()
                  for t in c.values())
    return dict(snapshot_bytes=n_bytes,
                host_part_bytes=len(json.dumps(snap["host"])),
                snapshot_s=snapshot_s, restore_s=restore_s,
                finished_before=len(done_before)), snap


def disk_snapshot_check(cfg, model, device, trace, kw, clean, snap) -> dict:
    """The paged bf16 form's snapshot saved to a temporary directory (its
    free space checked first), loaded with the digest verified, restored
    and finished token for token; a leaf bit-flipped by FaultPlan.corrupt
    refused; the directory deleted."""
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.core import errors as ERR
    from repro_torch.serving import Engine, FaultPlan, FaultSpec
    a, _, done_before = mid_trace(cfg, model, device, False, kw, trace)
    need = 2 * sum(t.numel() * t.element_size()
                   for c in snap["arrays"].values() for t in c.values())
    root = artifact_dir(need)
    try:
        t0 = time.perf_counter()
        committed = a.save_snapshot(root)
        save_s = time.perf_counter() - t0
        on_disk = dir_bytes(committed)
        t0 = time.perf_counter()
        CKPT.load(root, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = Engine.restore(root, cfg=cfg, params=model, device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check({**done_before, **uid_tokens(b.run())} == clean,
              "disk snapshot: the restored engine's tokens differ")
        leaf = max(committed.glob("leaf_*.npy"),
                   key=lambda f: f.stat().st_size)
        plan = FaultPlan(seed=0, specs=(FaultSpec(
            site="ckpt", kind="corrupt", steps=(0,), byte_offsets=(-1,)),))
        leaf.write_bytes(plan.corrupt(leaf.read_bytes()))
        refused = False
        try:
            Engine.restore(root, cfg=cfg, params=model, device=device)
        except ERR.ArtifactCorruptError:
            refused = True
        check(refused, "disk snapshot: a corrupted leaf was not refused")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(bytes_on_disk=on_disk, save_s=save_s,
                load_with_digest_s=load_s, restore_from_disk_s=restore_s,
                corrupted_leaf_refused=True)


def cross_device_check(args, full_cfg, device) -> dict:
    """The reduced fp32 config (the rehearsal's, card == CPU token for
    token), paged pool: a snapshot taken on the card restored on the CPU,
    and one saved on the CPU restored onto the card, each finishing with
    the uninterrupted CPU run's tokens."""
    from repro_torch.models import model as MD
    from repro_torch.serving import Engine
    small = full_cfg.reduced().replace(dtype="float32")
    trace = make_trace(small.vocab_size, args.seed)
    cpu_model = MD.init(small, "cpu", seed=args.seed)
    gpu_model = MD.init(small, device, seed=args.seed)
    gpu_model.load_state_dict(cpu_model.state_dict())
    eng = resilience_engine(small, cpu_model, "cpu", False, **PAGED)
    reqs = submit_trace(eng, trace)
    eng.run()
    want = uid_tokens(reqs)
    out = {}
    for (src, m_src), (dst, m_dst) in (((device, gpu_model), ("cpu", cpu_model)),
                                       (("cpu", cpu_model), (device, gpu_model))):
        a, _, done = mid_trace(small, m_src, src, False, PAGED, trace)
        root = artifact_dir(1 << 30)
        try:
            a.save_snapshot(root)
            b = Engine.restore(root, cfg=small, params=m_dst, device=dst)
            got = {**done, **uid_tokens(b.run())}
        finally:
            shutil.rmtree(root, ignore_errors=True)
        check(got == want, f"a snapshot saved on {src} and restored on "
                           f"{dst} finished with other tokens")
        out[f"{src}_to_{dst}"] = "token for token"
    del cpu_model, gpu_model
    free()
    return out


def drill_on_the_card(args, layers: int, device) -> dict:
    """tests/_torch_snapshot_drill_child.py on the card in a child process
    (qwen3-moe at its published widths and ``layers`` deep, the paged pool,
    snapshots every 4 steps, os._exit after step DRILL_KILL_STEPS), then the
    directory restored here and finished: the child's finished requests and
    the restored engine's equal an uninterrupted run's tokens, and no
    request is lost."""
    import subprocess
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _torch_snapshot_drill_child import (KILL_CODE, build_trace,
                                             drill_engine_config,
                                             drill_model_config)
    cfg = drill_model_config(layers=layers)
    from repro_torch.serving import Engine
    child = Path(__file__).resolve().parent / "tests" / \
        "_torch_snapshot_drill_child.py"
    root = artifact_dir(1 << 30)
    try:
        t0 = time.perf_counter()
        src = str(Path(__file__).resolve().parent / "src")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        r = subprocess.run(
            [sys.executable, str(child), "--snapshot-dir", root,
             "--kill-after-steps", str(DRILL_KILL_STEPS), "--device",
             device, "--layers", str(layers), "--seed",
             str(args.seed)],
            capture_output=True, text=True, timeout=600, env=env)
        child_s = time.perf_counter() - t0
        check(r.returncode == KILL_CODE,
              f"drill child exited {r.returncode}: {r.stdout[-2000:]}"
              f"{r.stderr[-4000:]}")
        pre = [json.loads(line) for line in r.stdout.splitlines() if line]
        # the child's weights: the engine's seeded default, built here the
        # same way
        ec = drill_engine_config(reduced=False, seed=args.seed)
        trace = build_trace(cfg.vocab_size)
        full = Engine(ec, cfg=cfg, device=device)
        for t in trace:
            full.submit(t["prompt"], t["max_new_tokens"],
                        arrival_time=t["arrival_time"])
        want = uid_tokens(full.run())
        t0 = time.perf_counter()
        eng = Engine.restore(root, cfg=cfg, params=full.params,
                             device=device)
        restore_s = time.perf_counter() - t0
        at_step = eng.steps
        check(0 < at_step <= DRILL_KILL_STEPS,
              f"drill: restored at step {at_step}")
        post = uid_tokens(eng.run())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(all(rec["tokens"] == want[rec["uid"]] for rec in pre)
          and all(toks == want[u] for u, toks in post.items()),
          "drill: a pre-crash or post-restore stream differs from the "
          "uninterrupted run's")
    check(set(post) | {rec["uid"] for rec in pre} == set(want) and post,
          "drill: a request was lost across the crash")
    return dict(child_exit=r.returncode, child_s=child_s,
                finished_before_crash=len(pre), finished_after_restore=len(post),
                restored_at_step=at_step, restore_s=restore_s)


def resilience_phase(args, full_cfg, cfg, model, device, card) -> dict:
    """The resilience line: in each RESILIENCE_FORMS form on the card's
    graphs, the NaN quarantine, the retry budget and a snapshot restored
    token for token; the paged bf16 snapshot through the disk; a snapshot
    across devices; the hard-kill drill in a child process."""
    trace = make_trace(cfg.vocab_size, args.seed, n_requests=12,
                       new_tokens=24)
    forms = {}
    snaps = {}
    for form, kw, spec in RESILIENCE_FORMS:
        eng = resilience_engine(cfg, model, device, spec, **kw)
        reqs = submit_trace(eng, trace)
        eng.run()
        clean = uid_tokens(reqs)
        check(all(r.status == "ok" for r in reqs)
              and eng.counters["quarantined"] == 0
              and eng.counters["transient_retries"] == 0,
              f"{form}: the clean run is not clean")
        res = dict(quarantine=quarantine_check(cfg, model, device, trace,
                                               spec, kw, clean, form,
                                               args.seed),
                   retries=retry_checks(cfg, model, device, trace, spec, kw,
                                        clean, form, args.seed))
        res["snapshot"], snaps[form] = snapshot_check(
            cfg, model, device, trace, spec, kw, clean, form)
        if form == "paged bf16 KV":
            res["disk"] = disk_snapshot_check(cfg, model, device, trace, kw,
                                              clean, snaps[form])
        forms[form] = res
        free()
    return dict(layers=cfg.n_layers, requests=len(trace), forms=forms,
                across_devices=cross_device_check(args, full_cfg, device),
                drill=drill_on_the_card(args, cfg.n_layers, device),
                card=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24,
                    help="depth of the served model (widths are never cut); "
                         "24 is about 31 GB of bf16 weights, 48 about 61 GB")
    ap.add_argument("--variant-layers", type=int, default=4,
                    help="depth of the decode_block=1 / ragged comparison runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one decode block of the uncompressed "
                         "MoE model (bf16 and int8 expert tables) and of the "
                         "dense model (dense cache and paged int8 pool), and "
                         "one fixed-batch decode step of each family, with "
                         "torch.profiler and print where its time goes")
    ap.add_argument("--witness-layers", type=int, default=0,
                    help="also read the paged int8 pool's top-1 against the "
                         "bf16 pool at full width and this depth on the card "
                         "and on the CPU's plain path (minutes of CPU; off "
                         "by default)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    from repro_torch import configs, env
    from repro_torch.kernels import _build, ops
    from repro_torch.models import numerics

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products stay fp32
    # the train phase's resume drill runs under
    # torch.use_deterministic_algorithms(True), which asks cuBLAS for a fixed
    # workspace: this one is the size PyTorch picks on sm_90 anyway
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    dense_cfg = configs.get(DENSE)
    check((dense_cfg.family, dense_cfg.d_model, dense_cfg.n_heads,
           dense_cfg.n_kv_heads, dense_cfg.hd, dense_cfg.d_ff,
           dense_cfg.vocab_size, dense_cfg.n_layers)
          == ("dense", 4096, 32, 8, 128, 14336, 49152, 36),
          "granite-8b widths changed")

    # ---- rehearse: reduced configs, card vs CPU, every form
    t0 = time.perf_counter()
    small_dense, admission_rows = rehearse(args, full_cfg, dense_cfg, device)
    reduced_top1 = quality(args, full_cfg, device)
    t_rehearse = time.perf_counter() - t0

    # ---- kernels
    t0 = time.perf_counter()
    trace = make_trace(full_cfg.vocab_size, args.seed)
    n_cases, worst, invariance = case_list(device)
    checks, entries, quant_bitwise = main_path_shapes(
        device, full_cfg, admission_rows, decode_lens(trace), dense_cfg)
    prompt = admission_rows // full_cfg.moe.top_k
    flash = flash_main_shapes(
        device, full_cfg,
        [("admission", 1, prompt, torch.bfloat16),
         ("capture", CALIB_BATCH, CALIB_SEQ, torch.bfloat16),
         ("admission", 1, prompt, torch.float32)])
    checks.extend(flash)
    # zamba2's prefill at hd 80 (its tiles end on zero-filled columns past
    # hd in no k16 step: 80 is five of them; the bf16 route takes any
    # multiple of 8)
    flash_hd80 = flash_main_shapes(
        device, configs.get("zamba2-2.7b"),
        [("zamba2 prefill, hd 80", FAMILY_BATCH, FAMILY_PROMPT,
          torch.bfloat16)])
    checks.extend(flash_hd80)
    timed_keys = ("shape", "max_err", "ms", "device_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "library_device_ms")
    # the main entries are bf16 (the tensor-core routes); the fp32 route's
    # numbers ride along, and swiglu's admission shape beside its decode one
    entries["flash_attention"] = dict(flash[0], cuda_core_route={
        k: flash[2][k] for k in timed_keys}, hd80={
        k: flash_hd80[0][k] for k in timed_keys})
    swiglu, swiglu_timed = swiglu_main_shapes(device, prompt)
    checks.extend(swiglu)
    swiglu_timed["decode"]["round_gu_exact_sums"] = round_gu_exact(device)
    entries["swiglu_mlp"] = dict(
        swiglu_timed["decode"],
        admission={k: swiglu_timed["admission"][k]
                   for k in timed_keys + ("round_gu",)},
        cuda_core_route={k: swiglu_timed["fp32"][k] for k in timed_keys})
    emit("kernels", cases_passed=n_cases, worst_abs_err_case_list=worst,
         quantize_card_equals_cpu_bitwise=quant_bitwise,
         flash_attention_rows_invariant_bitwise=invariance,
         threefry_card_vs_cpu=threefry_on_the_card(device), card=card,
         checks=checks)
    t_kernels = time.perf_counter() - t0

    # ---- serve: full width; bf16 weights with the dense cache, the paged
    # pool and the paged int8 pool, then the same weights as int8 tables
    t0 = time.perf_counter()
    cfg = full_cfg.replace(n_layers=args.layers)
    model, build_s = build_model(cfg, device, args.seed)
    emit("contracts", layers=cfg.n_layers,
         **contracts(cfg, model, device, decode_lens(trace)))
    total_launches = {name: 0 for name in TABLE}
    total_routes = {name: dict.fromkeys(r, 0) for name, r in
                    ops.route_launch_counts().items()}

    def record(res, form, mcfg, n_weights, experts="bf16", kv="dense",
               family="moe", **extra):
        check_launches(res, mcfg.n_layers, experts=experts, kv=kv,
                       family=family)
        for name in total_launches:
            total_launches[name] += res["launches"][name]
        add_routes(total_routes, res["routes"])
        emit("serve", model=mcfg.name, form=form, layers=mcfg.n_layers,
             dtype=mcfg.dtype, weights_gb=n_weights, **extra,
             **serve_summary(res, card))

    bf16_gb = weights_gb(model)
    serve(cfg, model, trace[:2], device)                # warm the libraries up
    dense = serve(cfg, model, trace, device)
    check(dense["admits"] == small_dense["admits"],
          "admission shapes differ from the rehearsal")
    record(dense, "uncompressed", cfg, bf16_gb, init_s=build_s,
           lm_head_logits=("fp32 from torch.mm(out_dtype=float32)"
                           if numerics.mm_out_dtype_available()
                           else "bf16 product widened to fp32"))
    if args.profile:
        for eager in (False, True):
            emit("profile", model=cfg.name, experts="bf16", card=card,
                 **profile_block(cfg, model, trace, device, eager))
    # graph == eager in every form of the bf16 tables (and the single step),
    # then eager against graph in time
    for form, kw in (("dense cache", {}), ("paged bf16 KV", PAGED),
                     ("paged int8 KV", PAGED_INT8)):
        graph_check(cfg, model, trace, device, form, **kw)
    graph_check(cfg, model, trace, device, "dense cache, decode_block=1",
                n_requests=4, new_tokens=4, decode_block=1)
    emit("graph_timings", model=cfg.name, experts="bf16", kv="dense",
         layers=cfg.n_layers, card=card,
         **graph_timings(cfg, model, trace, device))
    pred = {"dense": teacher_forced(cfg, model, trace, dense["tokens"], device)}
    for form, kw, kv in (("paged bf16 KV", PAGED, "bf16"),
                         ("paged int8 KV", PAGED_INT8, "int8")):
        serve(cfg, model, trace[:2], device, **kw)
        res = serve(cfg, model, trace, device, **kw)
        check(res["paging_stats"]["prefix_hits"] > 0,
              f"{form}: no prefix hit on the shared-prefix trace")
        pred[form] = teacher_forced(cfg, model, trace, dense["tokens"], device,
                                    kv=kv)
        if kv == "bf16":
            # C3: dense decode runs the paged kernel over a contiguous
            # table and a prefix hit pads its suffix to the whole prompt's
            # bucket, so the two layouts are one computation
            check(res["tokens"] == dense["tokens"],
                  f"paged bf16 KV: tokens differ from the dense cache's on "
                  f"the shared-prefix trace ({top1(res['tokens'], dense['tokens'])}"
                  f" agree)")
            check(top1(pred[form], dense["tokens"]) == 1.0,
                  "paged bf16 KV: teacher-forced top-1 against dense != 1.0")
        record(res, form, cfg, bf16_gb, kv=kv,
               free_running_agreement_with_dense=top1(res["tokens"],
                                                      dense["tokens"]),
               teacher_forced_top1_vs_dense=top1(pred[form], dense["tokens"]))
    # a reading for the families line: the fixed-batch server on this model
    # (gather dispatch) against the engine, bounded by C5
    t1 = time.perf_counter()
    emit("families", form="reading: MoE fixed-batch server against the "
                          "engine (C5)",
         **moe_server_reading(args, cfg, model, device, card,
                              (total_launches, total_routes)),
         seconds=time.perf_counter() - t1)
    # speculative decoding at this depth: the model as its own draft and a
    # random 2-layer draft, verify == decode, the row-count reading
    t1 = time.perf_counter()
    spec_totals = (total_launches, total_routes)
    emit("spec", model=cfg.name, pair="self and adversarial drafts",
         card=card, **spec_self_and_adversarial(
             cfg, model, trace, device, card, dense["tokens"], spec_totals,
             args.seed), seconds=time.perf_counter() - t1)
    q_s = quantize(model)
    emit("contracts", layers=cfg.n_layers, form="int8 experts",
         **contracts_int8(cfg, model, device))
    serve(cfg, model, trace[:2], device)
    res = serve(cfg, model, trace, device)
    if args.profile:
        for eager in (False, True):
            emit("profile", model=cfg.name, experts="int8", card=card,
                 **profile_block(cfg, model, trace, device, eager))
        with int8_moe_route("cuda_core"):
            for eager in (False, True):
                emit("profile", model=cfg.name, experts="int8",
                     int8_moe_route="cuda_core (the route before "
                                    "tensor_core)",
                     card=card, **profile_block(cfg, model, trace, device,
                                                eager))
    graph_check(cfg, model, trace, device, "int8 experts")
    emit("graph_timings", model=cfg.name, experts="int8", kv="dense",
         layers=cfg.n_layers, card=card,
         **graph_timings(cfg, model, trace, device))
    pred["int8 experts"] = teacher_forced(cfg, model, trace, dense["tokens"],
                                          device)
    record(res, "int8 experts, uncompressed", cfg, weights_gb(model),
           experts="int8", quantize_s=q_s,
           free_running_agreement_with_dense=top1(res["tokens"],
                                                  dense["tokens"]),
           teacher_forced_top1_vs_dense=top1(pred["int8 experts"],
                                             dense["tokens"]))
    del model
    free()

    # ---- merged M = N/2 on the suffix, bf16 then int8
    mcfg = cfg.compressed(full_cfg.moe.n_experts // 2,
                          split=int(0.6 * cfg.n_layers))
    form = f"merged M={mcfg.moe_merged} on layers [{mcfg.moe_split}, " \
           f"{mcfg.n_layers})"
    model, build_s = build_model(mcfg, device, args.seed)
    serve(mcfg, model, trace[:2], device)
    merged = serve(mcfg, model, trace, device)
    record(merged, form, mcfg, weights_gb(model), init_s=build_s)
    graph_check(mcfg, model, trace, device, form)
    q_s = quantize(model)
    serve(mcfg, model, trace[:2], device)
    res = serve(mcfg, model, trace, device)
    merged_top1 = top1(teacher_forced(mcfg, model, trace, merged["tokens"],
                                      device), merged["tokens"])
    graph_check(mcfg, model, trace, device, form + ", int8 experts")
    record(res, form + ", int8 experts", mcfg, weights_gb(model),
           experts="int8", quantize_s=q_s,
           free_running_agreement_with_bf16_merged=top1(res["tokens"],
                                                        merged["tokens"]),
           teacher_forced_top1_vs_bf16_merged=merged_top1)
    del model
    free()
    # teacher forcing runs at the served batch: the dense engine's own
    # stream must read exactly 1.0, so every other reading is the form's
    full_width = {form: top1(p, dense["tokens"]) for form, p in pred.items()}
    check(full_width["dense"] == 1.0,
          f"full width: the dense engine's stream teacher-forced at its "
          f"served batch reads {full_width['dense']}, not 1.0")
    full_width["int8 experts, merged (vs bf16 merged)"] = merged_top1
    full_width["paged int8 KV vs paged bf16 KV, same contexts"] = top1(
        pred["paged int8 KV"], pred["paged bf16 KV"])
    emit("top1", card=card, reduced=reduced_top1,
         full_width=dict(layers=cfg.n_layers,
                         teacher_forced_top1_vs_dense=full_width))
    t_serve = time.perf_counter() - t0

    # ---- dense: granite-8b at its published widths and full depth, bf16
    t0 = time.perf_counter()
    model, build_s = build_model(dense_cfg, device, args.seed)
    dtrace = make_trace(dense_cfg.vocab_size, args.seed)
    emit("contracts", model=dense_cfg.name, layers=dense_cfg.n_layers,
         **contracts_dense(dense_cfg, model, device, dtrace))
    d_gb = weights_gb(model)
    serve(dense_cfg, model, dtrace[:2], device)         # warm the libraries up
    d_dense = serve(dense_cfg, model, dtrace, device)
    record(d_dense, "dense cache", dense_cfg, d_gb, family="dense",
           init_s=build_s)
    if args.profile:
        for eager in (False, True):
            emit("profile", model=dense_cfg.name, card=card,
                 **profile_block(dense_cfg, model, dtrace, device, eager))
            emit("profile", model=dense_cfg.name, kv="paged int8", card=card,
                 **profile_block(dense_cfg, model, dtrace, device, eager,
                                 **PAGED_INT8))
    for form, kw in (("dense cache", {}), ("paged bf16 KV", PAGED),
                     ("paged int8 KV", PAGED_INT8),
                     (f"dense cache, temperature {TEMPERATURE}",
                      dict(temperature=TEMPERATURE))):
        graph_check(dense_cfg, model, dtrace, device, form, **kw)
    for kv, kw in (("dense", {}), ("paged int8", PAGED_INT8)):
        emit("graph_timings", model=dense_cfg.name, kv=kv,
             layers=dense_cfg.n_layers, card=card,
             **graph_timings(dense_cfg, model, dtrace, device, **kw))
    for form, kw, kv in (("paged bf16 KV", PAGED, "bf16"),
                         ("paged int8 KV", PAGED_INT8, "int8")):
        res = serve(dense_cfg, model, dtrace, device, **kw)
        check(res["paging_stats"]["prefix_hits"] > 0,
              f"{dense_cfg.name}, {form}: no prefix hit on the shared-prefix "
              f"trace")
        if kv == "bf16":
            check(res["tokens"] == d_dense["tokens"],
                  f"{dense_cfg.name}, paged bf16 KV: tokens differ from the "
                  f"dense cache's ({top1(res['tokens'], d_dense['tokens'])} "
                  f"agree)")
        record(res, form, dense_cfg, d_gb, kv=kv, family="dense",
               free_running_agreement_with_dense=top1(res["tokens"],
                                                      d_dense["tokens"]))
    res = serve(dense_cfg, model, dtrace, device, temperature=TEMPERATURE)
    record(res, f"dense cache, temperature {TEMPERATURE}", dense_cfg, d_gb,
           family="dense",
           share_of_tokens_equal_to_greedy=top1(res["tokens"],
                                                d_dense["tokens"]))
    del model
    free()
    t_dense = time.perf_counter() - t0

    # ---- families: the fixed-batch server over every family (reduced fp32
    # card vs CPU, then mamba2, zamba2, whisper, phi-3-vision and granite at
    # their published widths and full depth, bf16)
    t0 = time.perf_counter()
    families_phase(args, device, card, (total_launches, total_routes))
    t_families = time.perf_counter() - t0

    # ---- train: the trainer on the card (reduced fp32 card vs CPU, the
    # resume drill), then qwen3-moe at its published widths, 4 layers
    t0 = time.perf_counter()
    emit("train", form="rehearse, reduced fp32, card vs CPU", card=card,
         **{name: train_card_vs_cpu(name, device) for name in (ARCH, DENSE)},
         resume=resume_drill(device))
    emit("train", form="rehearse the other families, reduced fp32, card vs "
                       "CPU", card=card,
         **{arch: train_family_card_vs_cpu(arch, device, args.seed)
            for arch in FAMILIES})
    for arch in FAMILIES:
        emit("train", form="full width, the other families",
             **train_family_full_width(arch, device, card, args.seed))
    tcfg, trained, line = train_full_width(args, full_cfg, device, card)
    emit("train", form="full width", **line)
    t_train = time.perf_counter() - t0

    # ---- compression: MergeMoE on the trained model, then the merged model
    # served
    t0 = time.perf_counter()
    handoff = [trained]
    del trained
    compress_launches, compress_routes = compress_phase(
        args, full_cfg, device, card, trace, tcfg, handoff)
    for name, n in compress_launches.items():
        total_launches[name] += n
    add_routes(total_routes, compress_routes)
    t_compress = time.perf_counter() - t0

    # ---- variants at a small depth: decode_block=1 and dispatch="ragged"
    t0 = time.perf_counter()
    vcfg = full_cfg.replace(n_layers=args.variant_layers)
    model, _ = build_model(vcfg, device, args.seed)

    def tps(r):
        return sum(map(len, r["tokens"])) / r["wall_s"]

    base = serve(vcfg, model, trace, device)
    check_launches(base, vcfg.n_layers)
    rag = serve(vcfg, model, trace, device, dispatch="ragged")
    check_launches(rag, vcfg.n_layers, dispatch="ragged")
    k1 = serve(vcfg, model, trace, device, decode_block=1)
    check_launches(k1, vcfg.n_layers)
    # a trace whose arrivals and completions fall on block boundaries: both
    # engines admit the same groups at the same steps
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
            share_of_tokens_equal=top1(k1["tokens"], base["tokens"]), tokens_per_s=tps(k1)))
    emit("serve", form="variants", card=card, **variants)
    t_variants = time.perf_counter() - t0
    check(variants["dispatch_ragged"]["token_equal"],
          "dispatch='ragged' gives other tokens than dispatch='gather'")
    check(variants["decode_block_1_same_admission_groups"]["token_equal"],
          "decode_block=1 gives other tokens than decode_block=8 although "
          "both admitted the same groups at the same steps")
    # every prompt is admitted alone, so WHEN it is admitted and with whom
    # does not change its tokens: the staggered trace must agree too
    check(variants["decode_block_1_staggered"]["token_equal"],
          "decode_block=1 gives other tokens than decode_block=8 on the "
          "staggered trace")
    # ---- resilience at the same depth, on the card's graphs
    t0 = time.perf_counter()
    emit("resilience", model=vcfg.name,
         **resilience_phase(args, full_cfg, vcfg, model, device, card),
         seconds=time.perf_counter() - t0)
    del model
    free()
    t_resilience = time.perf_counter() - t0
    if args.witness_layers > 0:
        emit("witness", card=card, **cpu_witness(args, full_cfg, device))

    # ---- the record
    kernels = []
    for name, meta in TABLE.items():
        rec = entries[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=total_launches[name],
            launches_by_route=total_routes[name],
            max_abs_err=rec["max_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec.get("library_ms"), shape=rec["shape"],
            **({"kernel_route": rec["route"]} if "route" in rec else {}),
            **{k: rec[k] for k in ("device_ms", "library_device_ms",
                                   "dense_family_shape",
                                   "previous_ms", "previous_device_ms",
                                   "ms_with_combine", "device_ms_with_combine",
                                   "previous_device_ms_with_combine",
                                   "admission", "round_gu",
                                   "round_gu_exact_sums", "merged_shape",
                                   "cuda_core_route", "hd80")
               if k in rec}))
        check(total_launches[name] > 0, f"{name} never launched on the main path")
    check_routes(total_routes, "bfloat16")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"seconds": dict(
        rehearse=t_rehearse, kernels=t_kernels, serve=t_serve, dense=t_dense,
        families=t_families, train=t_train, compress=t_compress, variants=t_variants,
        resilience=t_resilience,
        total=time.perf_counter() - t_start)}), flush=True)
    print(env.gpu_line() or torch.cuda.get_device_name(0), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
