"""Data pipeline: deterministic synthetic LM stream + file-backed token
shards, with checkpointable iteration state and per-host sharding hooks.

Design for 1000+ nodes: each host owns ``host_id``-strided shards of the
global batch; ``state()``/``restore()`` round-trip the cursor so a restart
(or an elastic re-shard onto a different host count) resumes mid-epoch
without data repetition. This container is single-host, but the host-count
parameters are honored throughout and unit-tested with >1 logical hosts.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    step: int = 0
    epoch: int = 0
    cursor: int = 0          # token offset within the corpus (file-backed)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "DataState":
        return DataState(**json.loads(s))


class SyntheticLM:
    """Deterministic synthetic token stream: a hash-seeded Markov-ish mix of
    repeated n-grams and noise — enough structure that a model visibly learns
    (loss drops below uniform) while requiring no data files."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._state = DataState()
        # small "phrase book" shared across hosts: structure to learn
        pb_rng = np.random.default_rng(seed)
        self.phrases = pb_rng.integers(
            0, vocab_size, size=(64, 8)).astype(np.int32)

    def state(self) -> DataState:
        return dataclasses.replace(self._state)

    def restore(self, st: DataState) -> None:
        self._state = dataclasses.replace(st)

    def _gen(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        out = np.empty((self.local_batch, self.seq), np.int32)
        for b in range(self.local_batch):
            toks = []
            while len(toks) < self.seq:
                if rng.random() < 0.7:
                    toks.extend(self.phrases[rng.integers(len(self.phrases))])
                else:
                    toks.extend(rng.integers(0, self.vocab, size=4))
            out[b] = np.asarray(toks[:self.seq], np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = {"tokens": self._gen(self._state.step)}
        self._state.step += 1
        return batch


class TokenFileDataset:
    """Binary token shards (int32 .bin files) packed into [B, S] batches.

    Hosts stride the corpus: host h reads sequences h, h+H, h+2H, ... so the
    union over hosts is exactly the corpus order.
    """

    def __init__(self, paths, seq_len: int, global_batch: int,
                 host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.tokens = np.concatenate(
            [np.fromfile(p, dtype=np.int32) for p in sorted(map(str, paths))])
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._state = DataState()
        self.n_seqs = len(self.tokens) // seq_len

    def state(self) -> DataState:
        return dataclasses.replace(self._state)

    def restore(self, st: DataState) -> None:
        self._state = dataclasses.replace(st)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        out = np.empty((self.local_batch, self.seq), np.int32)
        for i in range(self.local_batch):
            global_idx = (self._state.cursor + self.host_id
                          + i * self.num_hosts)
            seq_idx = global_idx % self.n_seqs
            if global_idx and seq_idx < self.num_hosts:
                self._state.epoch += 1
            s = seq_idx * self.seq
            out[i] = self.tokens[s:s + self.seq]
        self._state.cursor += self.local_batch * self.num_hosts
        self._state.step += 1
        return {"tokens": out}


def write_token_file(path, tokens: np.ndarray) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.asarray(tokens, np.int32).tofile(str(path))


def make_pipeline(cfg, seq_len: int, global_batch: int, *,
                  data_dir: Optional[str] = None, seed: int = 0,
                  host_id: int = 0, num_hosts: int = 1):
    if data_dir:
        paths = sorted(Path(data_dir).glob("*.bin"))
        if paths:
            return TokenFileDataset(paths, seq_len, global_batch,
                                    host_id=host_id, num_hosts=num_hosts)
    return SyntheticLM(cfg.vocab_size, seq_len, global_batch, seed=seed,
                       host_id=host_id, num_hosts=num_hosts)
