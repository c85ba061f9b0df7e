"""Serving: the fixed-batch server (every family) and the command line of the
continuous-batching engine (a Poisson trace).

    python -m repro_torch.launch.serve                      # reduced config, on the GPU
    python -m repro_torch.launch.serve --device cpu         # the plain PyTorch path
    python -m repro_torch.launch.serve --full-width --layers 24
    python -m repro_torch.launch.serve --kv-layout paged --kv-dtype int8
    python -m repro_torch.launch.serve --int8-experts
    python -m repro_torch.launch.serve --arch granite-8b --full-width --s-max 512

``--full-width`` serves the published widths of ``--arch`` with random
weights (``--layers`` cuts the depth so the model fits the card; a dense
config such as granite-8b fits at its full depth and needs no MoE flag).
The engine serves the dense and moe families. :class:`FixedBatchServer`
serves every family (``mamba2-370m``, ``zamba2-2.7b``, ``whisper-base``,
``phi-3-vision-4.2b`` too) from the library::

    srv = FixedBatchServer(ServeConfig(arch="zamba2-2.7b"), device="cpu")
    tokens = srv.generate(prompts)              # [B, max_new_tokens]

On the card the server replays its prefill and each decode step from CUDA
graphs (``srv.graph_stats()``); on the CPU it runs the same bodies eagerly.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import threefry as TF
from repro_torch.core.quant import quantize_model_experts
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD
from repro_torch.serving import Engine, EngineConfig, poisson_trace


@dataclasses.dataclass
class ServeConfig:
    """The reference's settings less ``batch_size`` and ``prompt_len``: the
    batch and the cache's rows are read from the prompts handed to
    :meth:`FixedBatchServer.generate`."""
    arch: str = "qwen3-moe-30b-a3b"
    reduced: bool = True
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0


class FixedBatchServer:
    """The reference's fixed-batch loop (its ``Server``): a batch of prompts
    of one length shares one scalar cache position and finishes before the
    next batch starts. It serves every family through the non-slot API
    (``model.prefill`` / ``decode_step``) and is the baseline the engine's
    tokens are held to.

    The reference jits the prefill and the step. On a CUDA device the
    server replays them from CUDA graphs (``launch/steps.py``): for the
    last (batch, ``s_max``) it served, one cache, allocated once and
    written in place, and one step graph (:class:`steps.GraphedStep` over
    :func:`steps.make_serve_step`, a static token buffer); for each prompt
    shape one prefill graph into that cache (:class:`steps.GraphedPrefill`,
    static buffers for the tokens and the ``patches`` / ``frames``); all of
    the server's graphs in one memory pool. Another (batch, ``s_max``)
    frees them and captures its own. A capture or a replay that
    fails raises. Sampling (argmax, or threefry at T > 0) runs on the
    device between the replays, as the reference samples between its
    jitted calls. Elsewhere (``_graph_maker`` None) the bodies run eagerly
    into a new cache per call.

    ``device`` is the caller's (default ``"cuda"``), never chosen for it;
    ``model``: the port's model on that device (default: random weights of
    ``cfg`` from ``sc.seed``). Sampling at ``sc.temperature > 0`` is the
    reference's: ``key, sub = split(key)`` then ``categorical(sub, logits /
    T)`` on JAX's threefry, from ``PRNGKey(sc.seed)``.

    One repair (ROADMAP C12): the cache holds every prompt row plus
    ``max_new_tokens``, a vlm's patch rows included; the reference sizes it
    ``prompt_len + max_new_tokens`` and its decode then writes the rows past
    that over the last one."""

    def __init__(self, sc: ServeConfig, cfg=None, model=None,
                 device="cuda"):
        self.sc = sc
        self.device = torch.device(device)
        self.cfg = cfg if cfg is not None else (
            configs.get(sc.arch).reduced() if sc.reduced
            else configs.get(sc.arch))
        if model is None:
            model = MD.init(self.cfg, self.device, seed=sc.seed)
        elif model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the server "
                             f"on {self.device}")
        self.model = model
        self._step = ST.make_serve_step(self.cfg)
        self._new_graph = self._graph_maker()
        self._graphed: dict = {}

    def _graph_maker(self):
        """Graph factory of the server's graphs: CUDA graphs sharing one
        memory pool and one side stream on a CUDA device; None elsewhere
        (the bodies run eagerly)."""
        if self.device.type != "cuda":
            return None
        with torch.cuda.device(self.device):
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(self.device)
        return lambda: ST.CudaGraph(pool, stream)

    def _graphed_for(self, batch_size: int, s_max: int) -> dict:
        """The cache, graphed prefill and graphed step of (``batch_size``,
        ``s_max``), built at first use. The server holds one such entry: a
        new (batch, ``s_max``) drops the last one's cache and graphs before
        it allocates its own."""
        key = (batch_size, s_max)
        if key not in self._graphed:
            self._graphed.clear()
            cache = MD.init_cache(self.cfg, batch_size, s_max, self.device)
            consts = MD.slot_consts(self.cfg, cache)
            token = torch.zeros((batch_size,), dtype=torch.int32,
                                device=self.device)
            self._graphed[key] = dict(
                cache=cache,
                prefill=ST.GraphedPrefill(
                    ST.make_serve_prefill(self.cfg, consts=consts),
                    self.model, cache, self._new_graph),
                step=ST.GraphedStep(ST.make_serve_step(self.cfg, consts),
                                    self.model, cache, (token,),
                                    self._new_graph))
        return self._graphed[key]

    def graph_stats(self) -> dict:
        """``{"<batch>x<s_max> <graph>": StepGraph.stats()}`` of every graph
        captured so far (empty off the card)."""
        out = {}
        for (b, s_max), g in self._graphed.items():
            for part in ("prefill", "step"):
                for name, sg in g[part].graphs.items():
                    out[f"{b}x{s_max} {name}"] = sg.stats()
        return out

    def _batch(self, prompts, extra_batch) -> dict:
        batch = {"tokens": torch.as_tensor(prompts).to(self.device,
                                                       torch.int32)}
        for key, val in (extra_batch or {}).items():
            batch[key] = torch.as_tensor(val).to(self.device)
        if self.cfg.family == "audio" and "frames" not in batch:
            batch["frames"] = torch.zeros(
                (batch["tokens"].shape[0], self.cfg.n_audio_ctx,
                 self.cfg.d_model), dtype=self.cfg.param_dtype,
                device=self.device)
        return batch

    def generate(self, prompts, extra_batch: Optional[dict] = None,
                 logits_out: Optional[list] = None) -> np.ndarray:
        """prompts: ``[B, P]`` integers -> ``[B, max_new_tokens]`` int32;
        the cache holds ``P`` rows (plus a vlm's patch rows) and
        ``max_new_tokens``. ``extra_batch``: ``patches`` (vlm) or ``frames``
        (audio; zeros in the model type when not given), numpy arrays or
        tensors. ``logits_out``: a list that receives a copy of the
        prefill's logits and of each step's, ``[B, V]`` fp32 on the
        device."""
        sc, cfg = self.sc, self.cfg
        batch = self._batch(prompts, extra_batch)
        rows = batch["tokens"].shape[1]
        if cfg.family == "vlm" and "patches" in batch:
            rows += batch["patches"].shape[1]
        s_max = rows + sc.max_new_tokens
        if self._new_graph is None:
            prefill = ST.make_serve_prefill(cfg, s_max=s_max)
            logits, cache = prefill(self.model, batch)
            step = self._step
        else:
            graphed = self._graphed_for(batch["tokens"].shape[0], s_max)
            logits, cache = graphed["prefill"](self.model, batch)
            step = graphed["step"]
        key = TF.prng_key(sc.seed, self.device)
        outs = []
        for _ in range(sc.max_new_tokens):
            if logits_out is not None:
                logits_out.append(logits.clone())
            if sc.temperature > 0:
                key, sub = TF.split(key)
                tok = TF.categorical(sub, logits / torch.full_like(
                    logits, sc.temperature))
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            outs.append(tok)
            logits, cache = step(self.model, cache, tok)
        if logits_out is not None:
            logits_out.append(logits.clone())
        return torch.stack(outs, dim=1).cpu().numpy()


# the reference's alias
Server = FixedBatchServer


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
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default="dense")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16",
                    help="paged pool storage (int8 needs --kv-layout paged)")
    ap.add_argument("--kv-block", type=int, default=16,
                    help="rows per paged block")
    ap.add_argument("--int8-experts", action="store_true",
                    help="quantize the expert tables to int8 before serving "
                         "(MoE configs)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    cfg = cfg if args.full_width else cfg.reduced()
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    ec = EngineConfig(arch=args.arch, reduced=not args.full_width,
                      n_slots=args.n_slots, s_max=args.s_max,
                      prefill_buckets=(args.prompt_len,),
                      kv_layout=args.kv_layout, kv_dtype=args.kv_dtype,
                      kv_block=args.kv_block)
    eng = Engine(ec, cfg=cfg, device=args.device)
    if args.int8_experts:
        quantize_model_experts(eng.params)
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
          f"dispatch={eng.cfg.moe.dispatch if eng.cfg.moe else 'dense-mlp'}, "
          f"experts {'/'.join(eng.expert_weight_dtypes())}, "
          f"{eng.ec.kv_layout} KV {eng.kv_dtype_served})")
    if eng.paging_stats:
        print(f"  paging {eng.paging_stats}")
    for r in done[:4]:
        print(f"  req {r.uid}: arrived@{r.arrival_time:.1f} "
              f"admitted@{r.t_admitted:.0f} done@{r.t_finished:.0f} "
              f"[{r.finish_reason}] first tokens {r.out_tokens[:6]}")


if __name__ == "__main__":
    main()
