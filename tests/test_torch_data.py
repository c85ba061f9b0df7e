"""The port's data pipeline (``repro_torch.data.pipeline``, its own copy of
the reference's) against the reference's, batch for batch and bit for bit:
``SyntheticLM`` over seeds, steps, host counts and a restored cursor;
``TokenFileDataset`` over shard files, hosts, epochs and a restored cursor;
``make_pipeline``'s choice; ``DataState``'s JSON both ways; and the
trainer's batches on the device as int64 tensors."""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from repro.data import pipeline as R
from repro_torch import configs
from repro_torch.data import pipeline as P
from repro_torch.launch import train as LT


def _same_stream(a, b, n):
    for _ in range(n):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("vocab,seq,batch,seed,host,hosts", [
    (100, 16, 4, 7, 0, 1), (151936, 64, 8, 0, 0, 1), (256, 16, 8, 3, 1, 2),
    (49152, 32, 12, 11, 2, 3)])
def test_synthetic_batches_are_the_references(vocab, seq, batch, seed, host,
                                              hosts):
    a = R.SyntheticLM(vocab, seq, batch, seed=seed, host_id=host,
                      num_hosts=hosts)
    b = P.SyntheticLM(vocab, seq, batch, seed=seed, host_id=host,
                      num_hosts=hosts)
    np.testing.assert_array_equal(a.phrases, b.phrases)
    _same_stream(a, b, 3)
    st = a.state()
    assert st.to_json() == b.state().to_json()
    # a cursor saved by one restores the other
    b2 = P.SyntheticLM(vocab, seq, batch, seed=seed, host_id=host,
                       num_hosts=hosts)
    b2.restore(P.DataState.from_json(st.to_json()))
    _same_stream(a, b2, 2)


def test_synthetic_deterministic_and_resumable():
    a = P.SyntheticLM(100, 16, 4, seed=7)
    b1 = [next(a)["tokens"] for _ in range(3)]
    st = a.state()
    b2 = next(a)["tokens"]
    a.restore(st)
    np.testing.assert_array_equal(next(a)["tokens"], b2)
    fresh = P.SyntheticLM(100, 16, 4, seed=7)
    np.testing.assert_array_equal(next(fresh)["tokens"], b1[0])


def _shards(tmp_path, n_tokens, parts):
    toks = np.arange(n_tokens, dtype=np.int32) * 7 % 1000
    bounds = np.linspace(0, n_tokens, parts + 1).astype(int)
    paths = []
    for i in range(parts):
        p = tmp_path / f"part{i}.bin"
        R.write_token_file(p, toks[bounds[i]:bounds[i + 1]])
        paths.append(p)
    return toks, paths


@pytest.mark.parametrize("seq,batch,host,hosts,steps", [
    (16, 2, 0, 1, 12), (16, 4, 1, 2, 9), (8, 6, 2, 3, 20)])
def test_file_batches_are_the_references(tmp_path, seq, batch, host, hosts,
                                         steps):
    _, paths = _shards(tmp_path, 16 * 10 + 5, 3)
    a = R.TokenFileDataset(paths, seq, batch, host_id=host, num_hosts=hosts)
    b = P.TokenFileDataset(list(reversed(paths)), seq, batch, host_id=host,
                           num_hosts=hosts)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    _same_stream(a, b, steps // 2)
    st = a.state()
    assert st.to_json() == b.state().to_json()
    b.restore(P.DataState.from_json(st.to_json()))
    _same_stream(a, b, steps - steps // 2)
    assert a.state().epoch == b.state().epoch > 0


def test_port_writes_the_references_token_files(tmp_path):
    toks = np.random.default_rng(0).integers(0, 2 ** 31 - 1, 100)
    P.write_token_file(tmp_path / "a" / "x.bin", toks)
    R.write_token_file(tmp_path / "b" / "x.bin", toks)
    assert (tmp_path / "a" / "x.bin").read_bytes() == \
        (tmp_path / "b" / "x.bin").read_bytes()


def test_file_dataset_hosts_partition_corpus(tmp_path):
    toks = np.arange(16 * 8, dtype=np.int32)
    P.write_token_file(tmp_path / "p.bin", toks)
    h0 = P.TokenFileDataset([tmp_path / "p.bin"], 16, 4, host_id=0,
                            num_hosts=2)
    h1 = P.TokenFileDataset([tmp_path / "p.bin"], 16, 4, host_id=1,
                            num_hosts=2)
    rows = np.concatenate([next(h0)["tokens"], next(h1)["tokens"]])
    assert sorted(r[0] for r in rows) == [0, 16, 32, 48]


@pytest.mark.parametrize("with_files", [False, True])
def test_make_pipeline_chooses_as_the_reference(tmp_path, with_files):
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    if with_files:
        _shards(tmp_path, 400, 2)
    a = R.make_pipeline(cfg, 16, 4, data_dir=str(tmp_path), seed=3)
    b = P.make_pipeline(cfg, 16, 4, data_dir=str(tmp_path), seed=3)
    assert type(a).__name__ == type(b).__name__ == (
        "TokenFileDataset" if with_files else "SyntheticLM")
    _same_stream(a, b, 3)


def test_trainer_batches_are_int64_on_the_device():
    batch = LT.to_device(next(P.SyntheticLM(256, 16, 4, seed=1)), "cpu")
    want = next(R.SyntheticLM(256, 16, 4, seed=1))["tokens"]
    assert batch["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["tokens"].numpy(), want)
