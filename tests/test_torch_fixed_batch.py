"""The fixed-batch server of the port (``launch/serve.py ::
FixedBatchServer``) against the reference's, token for token, on the same
weights and prompts (CPU, fp32 reduced configs): every family the reference
serves through it, greedy and at temperature 0.7; JAX's ``split`` and
``categorical`` against the port's threefry copy, bitwise; the port's
``Engine`` greedy == the port's ``FixedBatchServer`` (the reference's own
parity flow) on the dense and moe families; ``launch/input_specs.py``
against the reference's ``ShapeDtypeStruct``s for every arch x shape cell.

The models of the MoE family are of the merged shape at split 1 where the
case says so (``stack`` and ``stack_c``, random weights). Every reference
server is followed by ``set_activation_mesh(None)``: its constructor
installs the host mesh (ROADMAP R1).
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
from repro_torch import configs
from repro_torch.core import threefry as TF
from repro_torch.launch import input_specs as IS
from repro_torch.launch import serve as SV
from repro_torch.models import model as MD
from repro_torch.serving import Engine, EngineConfig

from _torch_port import no_activation_mesh, one_torch_thread  # noqa: F401
from _torch_port import fast_jit, ref_params

B, PROMPT, NEW = 2, 8, 6
TEMPERATURE = 0.7

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


def _cfg(mod, case):
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
    them (``_torch_port.fast_jit``), with the prompts. The
    reference's server is built with ``prompt_len`` counting a vlm's patch
    rows: sized without them its cache is too short and its decode writes
    over the last row (ROADMAP C12), while the port sizes the cache from the
    batch."""
    case = request.param
    rcfg, pcfg = _cfg(ref_configs, case), _cfg(configs, case)
    model = MD.init(pcfg, "cpu", seed=4)
    prompts, extra = _inputs(pcfg)
    rows = PROMPT + (pcfg.vlm_num_patches if pcfg.family == "vlm" else 0)
    sc = dict(arch=pcfg.name, max_new_tokens=NEW, seed=3)
    ref = RSV.FixedBatchServer(RSV.ServeConfig(batch_size=B, prompt_len=rows,
                                               **sc),
                               cfg=rcfg, params=ref_params(model))
    set_activation_mesh(None)
    ref._prefill = fast_jit(RST.make_serve_prefill(rcfg, s_max=rows + NEW))
    ref._step = fast_jit(RST.make_serve_step(rcfg))
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
    rcfg, pcfg = _cfg(ref_configs, "vlm"), _cfg(configs, "vlm")
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
