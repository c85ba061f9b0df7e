"""Sampling at temperature > 0 against the reference: JAX's threefry key
schedule copied into ``repro_torch.core.threefry`` (keys, fold_in, bits and
uniforms bit for bit, Gumbel noise to the ``log``'s rounding), the step
functions' ``sample_tokens``, and the engine's sampled streams token for
token with the reference ``Engine`` (fp32 reduced configs, see
``_torch_port``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as RST
from repro_torch.core import threefry as TF
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD

from _torch_port import (no_activation_mesh,  # noqa: F401
                         ARCH, DENSE_ARCH, dense_pair, engine_kwargs, model_pair,
                         port_engine, ref_engine, run_trace, trace_requests)

TEMPERATURE = 0.7
KV_BLOCK = 4
EDGES = [0, 1, 12345, 2**31 - 1]


def _jax_key(seed):
    return jax.random.PRNGKey(seed)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def gumbel_tol(g: np.ndarray) -> np.ndarray:
    """Two ulps at the scale of max(|g|, 1). Each of the two logs rounds to
    within one ulp of the other framework's (measured), and the outer one
    sees the inner's error at the scale of its argument, about 1: near g = 0
    a difference of one ulp of 1 is thousands of ulps of g itself."""
    return 2 * np.spacing(np.maximum(np.abs(g), 1.0).astype(np.float32))


@pytest.mark.parametrize("vocab", [256, 151936])
@pytest.mark.parametrize("data", EDGES)
@pytest.mark.parametrize("seed", EDGES)
def test_threefry_equals_jax(seed, data, vocab):
    key = TF.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), _words(_jax_key(seed)))
    jkey = jax.random.fold_in(_jax_key(seed), data)
    tkey = TF.fold_in(key, data)
    np.testing.assert_array_equal(tkey.numpy(), _words(jkey))
    np.testing.assert_array_equal(
        TF.random_bits(tkey, vocab).numpy(),
        _words(jax.random.bits(jkey, (vocab,), dtype=jnp.uint32)))
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.random.uniform(jkey, (vocab,), jnp.float32,
                                         minval=tiny, maxval=1.0))
    got = TF.uniform(tkey, vocab, minval=TF.TINY, maxval=1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = np.asarray(jax.random.uniform(jkey, (vocab,), jnp.float32))
    np.testing.assert_array_equal(TF.uniform(tkey, vocab).numpy().view(
        np.int32), plain.view(np.int32))
    g = np.asarray(jax.random.gumbel(jkey, (vocab,), jnp.float32))
    tg = TF.gumbel(tkey, vocab).numpy()
    assert np.all(np.abs(tg.astype(np.float64) - g) <= gumbel_tol(g))


def test_prng_key_takes_the_seed_mod_2_32_as_the_reference():
    for seed in (-1, -5, 2**31, 2**32 - 1, 2**32 + 3):
        np.testing.assert_array_equal(TF.prng_key(seed).numpy(),
                                      _words(_jax_key(seed)))


def test_batched_keys_equal_one_at_a_time():
    """A batch of keys and data gives each row's own fold_in and noise."""
    base = TF.prng_key(4)
    uids = torch.tensor([0, 3, 2**31 - 1, 77])
    keys = TF.fold_in(base, uids)
    pos = torch.tensor([0, 5, 2**31 - 1, 9])
    both = TF.gumbel(TF.fold_in(keys, pos), 300)
    for b in range(4):
        one = TF.fold_in(TF.fold_in(base, int(uids[b])), int(pos[b]))
        assert torch.equal(both[b], TF.gumbel(one, 300))
        np.testing.assert_array_equal(
            keys[b].numpy(),
            _words(jax.random.fold_in(_jax_key(4), int(uids[b]))))


@pytest.mark.parametrize("vocab", [256, 151936])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sample_tokens_equals_reference(temperature, vocab):
    rng = np.random.default_rng(vocab)
    B = 6
    logits = (rng.standard_normal((B, vocab)) * 3).astype(np.float32)
    uids = np.array([0, 1, 5, 9, 2**31 - 1, 40])
    keys = np.stack([np.asarray(jax.random.fold_in(_jax_key(1), int(u)))
                     for u in uids])
    pos = np.array([0, 3, 17, 2**31 - 1, 100, 511], np.int32)
    want = RST.sample_tokens(jnp.asarray(logits), temperature,
                             jnp.asarray(keys), jnp.asarray(pos))
    got = ST.sample_tokens(torch.from_numpy(logits), temperature,
                           torch.from_numpy(keys.astype(np.int64)),
                           torch.from_numpy(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the noise moves the choice away from greedy somewhere in the batch
    assert (got != torch.from_numpy(logits).argmax(-1)).any()


def test_sampling_needs_keys_and_positions():
    logits = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="keys"):
        ST.sample_tokens(logits, 0.5)
    assert ST.sample_tokens(logits, 0.0).tolist() == [0, 0]


def test_fused_block_samples_the_step_loops_tokens():
    """K fused steps and K single steps draw the same noise at the same
    positions: the same tokens, the decode step's token lane included."""
    _, _, pcfg, model = model_pair("full")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (3, 8)).astype(
        np.int32))
    lengths = torch.tensor([8, 5, 7], dtype=torch.int32)
    keys = TF.fold_in(TF.prng_key(1), torch.tensor([4, 0, 9]))

    def fresh():
        cache = MD.init_slot_cache(pcfg, 3, 24, "cpu")
        _, g, cache = ST.make_slot_admit(pcfg)(model, cache, toks, lengths,
                                               np.arange(3, dtype=np.int32))
        return cache, g

    act = torch.ones(3, dtype=torch.bool)
    cache, first = fresh()
    K = 5
    block, _, _ = ST.make_slot_decode_multi(pcfg, K, TEMPERATURE)(
        model, cache, first, act, torch.full((3,), 99, dtype=torch.int32),
        torch.full((3,), -1, dtype=torch.int32), keys)
    cache, tok = fresh()
    step = ST.make_slot_decode(pcfg, TEMPERATURE)
    stepwise = []
    for _ in range(K):
        _, aux, cache = step(model, cache, tok, act, keys)
        tok = aux[:, 0]
        stepwise.append(tok)
    assert torch.equal(block[:, :, 0], torch.stack(stepwise))
    greedy, _, _ = ST.make_slot_decode_multi(pcfg, K)(
        model, fresh()[0], first, act, torch.full((3,), 99, dtype=torch.int32),
        torch.full((3,), -1, dtype=torch.int32))
    assert not torch.equal(block[:, :, 0], greedy[:, :, 0])


def _tokens(done):
    return [list(r.out_tokens) for r in done]


def _kw(arch, layout, K=8, dispatch="gather"):
    kw = engine_kwargs(decode_block=K, dispatch=dispatch, arch=arch)
    kw["temperature"] = TEMPERATURE
    if layout == "paged":
        kw.update(kv_layout="paged", kv_block=KV_BLOCK)
    return kw


def _sampled(family):
    """One reduced model of the family, the trace, and the reference
    ``Engine``'s sampled tokens in the dense and the paged layout (its own
    suite pins that they do not depend on decode_block or dispatch)."""
    if family == "qwen3":
        rcfg, params, pcfg, model = model_pair("full")
        arch = ARCH
    else:
        rcfg, params, pcfg, model = dense_pair()
        arch = DENSE_ARCH
    reqs = trace_requests(rcfg.vocab_size)
    ref = {}
    for layout in ("dense", "paged"):
        done = run_trace(ref_engine(rcfg, params, **_kw(arch, layout)), reqs)
        assert all(r.status == "ok" for r in done)
        ref[layout] = _tokens(done)
    greedy = _tokens(run_trace(ref_engine(
        rcfg, params, **dict(_kw(arch, "dense"), temperature=0.0)), reqs))
    assert greedy != ref["dense"]            # the noise changed the streams
    return dict(arch=arch, pcfg=pcfg, model=model, reqs=reqs, ref=ref)


@pytest.fixture(scope="module")
def sampled_moe():
    return _sampled("qwen3")


@pytest.fixture(scope="module")
def sampled_dense():
    return _sampled("granite")


def _check_engine(s, layout, K, dispatch="gather"):
    eng = port_engine(s["pcfg"], s["model"],
                      **_kw(s["arch"], layout, K, dispatch))
    done = run_trace(eng, s["reqs"])
    assert all(r.status == "ok" for r in done)
    assert _tokens(done) == s["ref"][layout]
    # one readback per admission group and per block or step, sampling
    # included
    assert eng.counters["host_syncs"] == eng.counters["device_calls"]


@pytest.mark.parametrize("dispatch", ["gather", "ragged"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_moe_engine_token_for_token_vs_reference(sampled_moe, layout,
                                                         K, dispatch):
    _check_engine(sampled_moe, layout, K, dispatch)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_dense_engine_token_for_token_vs_reference(sampled_dense,
                                                           layout, K):
    _check_engine(sampled_dense, layout, K)
