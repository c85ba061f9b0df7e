"""Every family of the port against the reference (CPU, fp32, the reduced
config of each ``ARCH_IDS`` entry, the same weights in both), and the
fixed-batch server of the port (``launch/serve.py :: FixedBatchServer``)
against the reference's.

The model API: ``forward`` logits (vlm with patches, audio with frames),
``prefill`` logits and cache (the KV rows below ``pos``, the SSM states, the
encoder's output), two ``decode_step``s with their caches; the reference's
own decode == forward contract (``tests/test_decode_parity.py``: its
tolerance, atol 0.08, rtol 0.05) on the port alone; ``init_cache`` against
the reference's shapes; the converter's round trip, bitwise; every family's
``Model`` built from a seed; the engine still refusing the non-token
families.

The server, token for token, on the same weights and prompts: every family
the reference serves through it, greedy and at temperature 0.7; JAX's
``split`` and ``categorical`` against the port's threefry copy, bitwise;
the port's ``Engine`` greedy == the port's ``FixedBatchServer`` (the
reference's own parity flow) on the dense and moe families;
``launch/input_specs.py`` against the reference's ``ShapeDtypeStruct``s for
every arch x shape cell. The models of the MoE family are of the merged
shape at split 1 where the case says so (``stack`` and ``stack_c``, random
weights). Every reference server is followed by
``set_activation_mesh(None)``: its constructor installs the host mesh
(ROADMAP R1).

Tolerance against the reference: fp32 logits and caches 1e-4 (the two
frameworks sum in their own order; the largest gap seen is about 5e-6).
Each reference function is compiled once per config and shape
(``_torch_port.fast_jit``), and the model API's prefill and decode step run
at the server's shape (``PROMPT`` tokens, ``s_max`` of the prompt and
``NEW`` tokens), so the two share them (:func:`ref_serve`); the weights are
the port's, drawn from a seed and handed to the reference as its tree (its
own init would cost a compile per config).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import input_specs as RIS
from repro.launch import serve as RSV
from repro.launch import steps as RST
from repro.models import model as RMD
from repro.models.numerics import set_activation_mesh
from repro_torch import configs, convert
from repro_torch.core import threefry as TF
from repro_torch.launch import input_specs as IS
from repro_torch.launch import serve as SV
from repro_torch.models import mamba as S
from repro_torch.models import model as MD
from repro_torch.serving import Engine, EngineConfig

from _torch_port import no_activation_mesh, one_torch_thread  # noqa: F401
from _torch_port import fast_jit, ref_params, ref_tree_numpy

#: the model API's batch and full sequence (the reference decode-parity
#: test's shape); the server's prompt and new tokens, the model API's
#: prompt too
B, SEQ = 2, 16
PROMPT, NEW = 8, 6
TEMPERATURE = 0.7
TOL = dict(rtol=1e-4, atol=1e-4)

_REF = {}


def ref_serve(rcfg, s_max: int):
    """The reference's jitted serve prefill at ``s_max`` and serve step of
    ``rcfg``, built once for the module (``fast_jit`` compiles each call
    signature once) and shared by the model API's cases and the server's."""
    key = (rcfg, s_max)
    if key not in _REF:
        _REF[key] = (fast_jit(RST.make_serve_prefill(rcfg, s_max=s_max)),
                     fast_jit(RST.make_serve_step(rcfg)))
    return _REF[key]


# ---------------------------------------------------------------------------
# the model API of every family
# ---------------------------------------------------------------------------

def _cfg(mod, arch, dtype="float32"):
    cfg = mod.get(arch).reduced().replace(dtype=dtype)
    if cfg.moe is not None:           # the port serves gather / ragged
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  dispatch="gather"))
    return cfg


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _batch(cfg, rng):
    toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm_num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _prompt(batch):
    return dict(batch, tokens=batch["tokens"][:, :PROMPT])


@pytest.fixture(scope="module", params=ref_configs.ARCH_IDS)
def run(request):
    """One family's models, inputs and the reference's outputs: forward,
    prefill of the first PROMPT tokens at the server's s_max (PROMPT + NEW,
    the patch rows included) and the two decode steps after it with their
    caches."""
    arch = request.param
    rcfg, pcfg = _cfg(ref_configs, arch), _cfg(configs, arch)
    params = ref_params(MD.init(pcfg, "cpu", seed=1))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    batch = _batch(rcfg, np.random.default_rng(2))
    s_max = PROMPT + NEW + (rcfg.vlm_num_patches if rcfg.family == "vlm"
                            else 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    full, _, _ = fast_jit(lambda p, b: RMD.forward(rcfg, p, b))(params, jb)
    prefill, step = ref_serve(rcfg, s_max)
    steps = [prefill(params, _prompt(jb))]
    for t in DECODED:
        steps.append(step(params, steps[-1][1], jb["tokens"][:, t]))
    return dict(arch=arch, rcfg=rcfg, pcfg=pcfg, params=params, model=model,
                batch=batch, s_max=s_max, full=full, steps=steps)


#: the positions the two decode steps feed
DECODED = (PROMPT, PROMPT + 1)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cache_close(pcfg, got, want):
    """The port's cache against the reference's: the KV rows below ``pos``
    (the port allocates its rows up front, rounded up to a block), the SSM
    states, the encoder's output, ``pos``."""
    pos = int(want["pos"])
    assert int(got["pos"]) == pos and got["pos"].dim() == 0
    if "k" in want:
        for key in ("k", "v"):
            w = _np(want[key])
            assert got[key].shape[:2] == w.shape[:2]
            assert got[key].shape[2] >= w.shape[2] >= pos
            np.testing.assert_allclose(_np(got[key])[:, :, :pos],
                                       w[:, :, :pos], **TOL)
    if "ssm" in want:
        for g, w in zip(got["ssm"], want["ssm"]):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
    if "enc" in want:
        np.testing.assert_allclose(_np(got["enc"]), _np(want["enc"]), **TOL)
    assert set(want) <= set(got)


def test_forward_vs_reference(run):
    logits, aux, _ = MD.forward(run["pcfg"], run["model"], _tb(run["batch"]))
    assert logits.shape == (B, SEQ, run["pcfg"].vocab_size)
    np.testing.assert_allclose(_np(logits), _np(run["full"]), **TOL)
    assert float(aux) == 0.0 or run["pcfg"].moe is not None


def test_prefill_and_decode_vs_reference(run):
    pcfg, model = run["pcfg"], run["model"]
    logits, cache = MD.prefill(pcfg, model, _tb(_prompt(run["batch"])),
                               s_max=run["s_max"])
    want_logits, want_cache = run["steps"][0]
    np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
    _cache_close(pcfg, cache, want_cache)
    toks = run["batch"]["tokens"]
    for t, (want_logits, want_cache) in zip(DECODED, run["steps"][1:]):
        logits, out = MD.decode_step(pcfg, model, cache,
                                     torch.from_numpy(toks[:, t]))
        assert out is cache                              # in place
        np.testing.assert_allclose(_np(logits), _np(want_logits), **TOL)
        _cache_close(pcfg, cache, want_cache)


def test_decode_matches_forward_on_the_port(run):
    """The reference's contract (tests/test_decode_parity.py) held by the
    port alone."""
    pcfg, model, batch = run["pcfg"], run["model"], _tb(run["batch"])
    full, _, _ = MD.forward(pcfg, model, batch)
    plog, cache = MD.prefill(pcfg, model, _tb(_prompt(run["batch"])),
                             s_max=run["s_max"])
    np.testing.assert_allclose(_np(plog), _np(full[:, PROMPT - 1]),
                               atol=0.08, rtol=0.05)
    for t in DECODED:
        dlog, cache = MD.decode_step(pcfg, model, cache,
                                     batch["tokens"][:, t])
        np.testing.assert_allclose(_np(dlog), _np(full[:, t]), atol=0.08,
                                   rtol=0.05)


def test_init_cache_shapes_vs_reference(run):
    rcfg, pcfg = run["rcfg"], run["pcfg"]
    want = jax.eval_shape(lambda: RMD.init_cache(rcfg, 3, 64))
    got = MD.init_cache(pcfg, 3, 64, "cpu")
    for key, w in want.items():
        g = got[key]
        pairs = zip(g, w) if key == "ssm" else [(g, w)]
        for gl, wl in pairs:
            assert tuple(gl.shape) == wl.shape, key
            assert str(gl.dtype).split(".")[-1] == str(wl.dtype), key
            assert not bool(gl.any())
    if rcfg.family in ("ssm", "hybrid"):
        assert isinstance(got["ssm"], S.SSMState)


def test_convert_round_trip_is_bitwise(run):
    """reference tree -> port -> reference tree, leaf for leaf and bitwise,
    dtypes kept; and a bf16 model of the family (random weights) through
    the same round trip, its fp32 leaves (the Mamba2 blocks' dt_bias, A_log,
    D) staying fp32, every leaf's dtype the reference's."""
    back = convert.tree_to_numpy(convert.reference_tree(run["model"]))
    want = ref_tree_numpy(run["params"])
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w)

    rcfg = run["rcfg"].replace(dtype="bfloat16")
    pcfg = run["pcfg"].replace(dtype="bfloat16")
    m16 = MD.init(pcfg, "cpu", seed=3)
    tree = convert.reference_tree(m16)
    again = convert.from_reference_params(tree, pcfg, "cpu")
    for (n1, a), (n2, b) in zip(m16.state_dict().items(),
                                again.state_dict().items()):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1
    shapes = jax.eval_shape(lambda: RMD.init(rcfg, jax.random.PRNGKey(0)))
    flat_s = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_s) == len(flat_t)
    for path, s in flat_s:
        t = flat_t[path]
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).split(".")[-1] == str(s.dtype), path


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "mamba2-370m",
                                  "zamba2-2.7b", "whisper-base"])
def test_every_family_builds_and_the_engine_refuses_it(arch):
    """``Model`` takes the vlm, ssm, hybrid and audio families (random
    weights from a seed, the reference's sub-modules), and the
    continuous-batching engine refuses them, as the reference's does."""
    cfg = configs.get(arch).reduced()
    model = MD.init(cfg, "cpu", seed=0)
    subs = {"vlm": ("stack",), "ssm": ("ssm_ln", "ssm"),
            "hybrid": ("hybrid",), "audio": ("encdec",)}[cfg.family]
    assert all(hasattr(model, s) for s in subs)
    assert model.stacks() == ([model.stack] if cfg.family == "vlm" else [])
    again = MD.init(cfg, "cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    with pytest.raises(NotImplementedError, match=cfg.family):
        Engine(EngineConfig(arch=arch), cfg=cfg, params=model, device="cpu")
    with pytest.raises(NotImplementedError, match="slot"):
        MD.init_slot_cache(cfg, 2, 16, "cpu")


# ---------------------------------------------------------------------------
# the fixed-batch server
# ---------------------------------------------------------------------------

#: case -> (arch, MoE dispatch or None, merged at split 1)
CASES = {
    "dense": ("granite-8b", None, False),
    "moe-dense": ("qwen3-moe-30b-a3b", "dense", False),
    "moe-gather": ("qwen3-moe-30b-a3b", "gather", False),
    "merged": ("qwen3-moe-30b-a3b", "gather", True),
    "vlm": ("phi-3-vision-4.2b", None, False),
    "audio": ("whisper-base", None, False),
    "ssm": ("mamba2-370m", None, False),
    "hybrid": ("zamba2-2.7b", None, False),
}


def _case_cfg(mod, case):
    arch, dispatch, merged = CASES[case]
    cfg = mod.get(arch).reduced().replace(dtype="float32")
    if dispatch is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return cfg.compressed(4, split=1) if merged else cfg


def _inputs(cfg):
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.vlm_num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return prompts, extra


@pytest.fixture(scope="module", params=list(CASES))
def served(request):
    """One case's port model and server on the CPU and the reference's
    server on the same weights, its two jitted steps built as it builds
    them (:func:`ref_serve`, shared with the model API's cases), with the
    prompts. The
    reference's server is built with ``prompt_len`` counting a vlm's patch
    rows: sized without them its cache is too short and its decode writes
    over the last row (ROADMAP C12), while the port sizes the cache from the
    batch."""
    case = request.param
    rcfg, pcfg = _case_cfg(ref_configs, case), _case_cfg(configs, case)
    model = MD.init(pcfg, "cpu", seed=4)
    prompts, extra = _inputs(pcfg)
    rows = PROMPT + (pcfg.vlm_num_patches if pcfg.family == "vlm" else 0)
    sc = dict(arch=pcfg.name, max_new_tokens=NEW, seed=3)
    ref = RSV.FixedBatchServer(RSV.ServeConfig(batch_size=B, prompt_len=rows,
                                               **sc),
                               cfg=rcfg, params=ref_params(model))
    set_activation_mesh(None)
    ref._prefill, ref._step = ref_serve(rcfg, rows + NEW)
    port = SV.FixedBatchServer(SV.ServeConfig(**sc),
                               cfg=pcfg, model=model, device="cpu")
    return dict(case=case, ref=ref, port=port, prompts=prompts, extra=extra,
                pcfg=pcfg, model=model, sc=sc)


def _generate(server, s, temperature):
    server.sc = dataclasses.replace(server.sc, temperature=temperature)
    extra = ({k: jnp.asarray(v) for k, v in s["extra"].items()}
             if server is s["ref"] else s["extra"])
    out = server.generate(s["prompts"], extra or None)
    return np.asarray(out)


@pytest.mark.parametrize("temperature", [0.0, TEMPERATURE],
                         ids=["greedy", "T0.7"])
def test_fixed_batch_server_token_for_token(served, temperature):
    want = _generate(served["ref"], served, temperature)
    got = _generate(served["port"], served, temperature)
    assert got.shape == (B, NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if served["pcfg"].family == "audio":
        # without frames both servers encode zeros in the model type
        np.testing.assert_array_equal(
            served["port"].generate(served["prompts"]),
            np.asarray(served["ref"].generate(served["prompts"])))


def test_c12_reference_cache_misses_the_patch_rows():
    """ROADMAP C12, asserted so that this test notes when the reference
    changes: the reference server's prefill sizes its cache ``prompt_len +
    max_new_tokens``, so with a vlm's patches in front the decode runs out
    of rows ``vlm_num_patches`` steps early (JAX then clamps each write onto
    the last row); the port's server sizes the cache from the batch."""
    rcfg, pcfg = _case_cfg(ref_configs, "vlm"), _case_cfg(configs, "vlm")
    model = MD.init(pcfg, "cpu", seed=4)
    prompts, extra = _inputs(pcfg)
    batch = {"tokens": jnp.asarray(prompts),
             "patches": jnp.asarray(extra["patches"])}
    _, cache = jax.eval_shape(lambda: RMD.prefill(
        rcfg, ref_params(model), batch, s_max=PROMPT + NEW))
    rows = PROMPT + pcfg.vlm_num_patches
    assert cache["k"].shape[2] == max(rows, PROMPT + NEW) < rows + NEW
    port = SV.FixedBatchServer(SV.ServeConfig(max_new_tokens=NEW),
                               cfg=pcfg, model=model, device="cpu")
    seen = []
    port._step = (lambda step: lambda m, c, t: seen.append(
        (int(c["s_max"]), int(c["pos"]))) or step(m, c, t))(port._step)
    port.generate(prompts, extra)
    assert seen[0] == (rows + NEW, rows) and seen[-1][1] == rows + NEW - 1


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
@pytest.mark.parametrize("shape", [(1, 7), (3, 50), (4, 256)])
def test_split_and_categorical_equal_jax(seed, shape):
    """``key, sub = split(key)`` then ``categorical(sub, logits / T)``, the
    reference server's sampling, bit for bit: the keys of three rounds and
    the sampled ids."""
    jkey, tkey = jax.random.PRNGKey(seed), TF.prng_key(seed)
    lg = np.random.default_rng(seed % 97).standard_normal(shape).astype(
        np.float32) * 3
    lt = torch.from_numpy(lg)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        pair = TF.split(tkey)
        assert pair.shape == (2, 2)
        tkey, tsub = pair[0], pair[1]
        assert np.array_equal(np.asarray(jsub).astype(np.int64),
                              tsub.numpy())
        want = np.asarray(jax.random.categorical(jsub, jnp.asarray(lg)
                                                 / TEMPERATURE))
        got = TF.categorical(tsub, lt / torch.full_like(lt, TEMPERATURE))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    four = TF.split(TF.prng_key(seed), 4)
    np.testing.assert_array_equal(
        four.numpy(),
        np.asarray(jax.random.split(jax.random.PRNGKey(seed), 4)).astype(
            np.int64))


@pytest.mark.parametrize("arch,dispatch", [("granite-8b", None),
                                           ("qwen3-moe-30b-a3b", "gather")])
def test_engine_greedy_equals_the_fixed_batch_server(arch, dispatch):
    """The reference's parity flow on the port alone: the same prompts
    through the continuous-batching engine (all admitted at once) and the
    fixed-batch server give the same greedy tokens."""
    cfg = configs.get(arch).reduced().replace(dtype="float32")
    if dispatch is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    model = MD.init(cfg, "cpu", seed=2)
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    srv = SV.FixedBatchServer(SV.ServeConfig(arch=arch, max_new_tokens=NEW),
                              cfg=cfg, model=model, device="cpu")
    want = srv.generate(prompts)
    eng = Engine(EngineConfig(arch=arch, n_slots=4, s_max=PROMPT + NEW,
                              prefill_buckets=(PROMPT,), dispatch=dispatch),
                 cfg=cfg, params=model, device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW)
    done = sorted(eng.run(), key=lambda r: r.uid)
    np.testing.assert_array_equal(np.stack([r.out_tokens for r in done]),
                                  want)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_spec(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert got.device.type == "meta"
    assert str(got.dtype).split(".")[-1] == str(want.dtype)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    """Every (arch, shape) cell: the batch or the decode cache and token as
    meta tensors of the reference's shapes and dtypes (the port's cache
    carries its ``s_max`` / ``kv_block`` host scalars too); ``long_500k`` on
    a full-attention arch refused as the reference refuses it."""
    for shape in configs.SHAPES:
        if not ref_configs.shape_applicable(ref_configs.get(arch), shape):
            with pytest.raises(ValueError, match="skipped"):
                IS.input_specs(arch, shape)
            with pytest.raises(ValueError, match="skipped"):
                RIS.input_specs(arch, shape)
            continue
        want, got = RIS.input_specs(arch, shape), IS.input_specs(arch, shape)
        assert got["kind"] == want["kind"]
        assert got["cfg"].to_json_dict() == want["cfg"].to_json_dict()
        if want["kind"] == "decode":
            _same_spec(got["token"], want["token"])
            wl, gl = _leaves(want["cache"]), _leaves(got["cache"])
            assert set(wl) <= set(gl)
            assert set(gl) - set(wl) <= {"['s_max']", "['kv_block']"}
            for key, w in wl.items():
                _same_spec(gl[key], w)
        else:
            assert set(got["batch"]) == set(want["batch"])
            for key, w in want["batch"].items():
                _same_spec(got["batch"][key], w)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "whisper-base"])
def test_params_specs_equal_the_reference(arch):
    """The reference's parameter tree at the published widths, as meta
    tensors: the same leaves, shapes and dtypes, no memory."""
    want = _leaves(RIS.params_specs(ref_configs.get(arch)))
    got = _leaves(IS.params_specs(configs.get(arch)))
    assert set(got) == set(want)
    for key, w in want.items():
        _same_spec(got[key], w)
