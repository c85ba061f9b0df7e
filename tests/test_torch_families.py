"""Every family of the port against the reference (CPU, fp32, the reduced
config of each ``ARCH_IDS`` entry, the same weights in both):
``forward`` logits (vlm with patches, audio with frames), ``prefill`` logits
and cache (the KV rows below ``pos``, the SSM states, the encoder's
output), two ``decode_step``s with their caches; the reference's own decode
== forward contract (``tests/test_decode_parity.py``: its positions, atol
0.08, rtol 0.05) on the port alone; ``init_cache`` against the reference's
shapes; the converter's round trip, bitwise; every family's ``Model`` built
from a seed; the engine still refusing the non-token families.

Tolerance against the reference: fp32 logits and caches 1e-4 (the two
frameworks sum in their own order; the largest gap seen is about 5e-6).
Each reference function is jitted once per config (``_torch_port.fast_jit``);
the weights are the
port's, drawn from a seed and handed to the reference as its tree (its own
init would cost a compile per config).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RMD
from repro_torch import configs, convert
from repro_torch.models import mamba as S
from repro_torch.models import model as MD
from repro_torch.serving import Engine, EngineConfig

from _torch_port import no_activation_mesh, one_torch_thread  # noqa: F401
from _torch_port import fast_jit, ref_params, ref_tree_numpy

B, SEQ = 2, 16            # the reference decode-parity test's shape
TOL = dict(rtol=1e-4, atol=1e-4)


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
    return dict(batch, tokens=batch["tokens"][:, :SEQ - 2])


@pytest.fixture(scope="module", params=ref_configs.ARCH_IDS)
def run(request):
    """One family's models, inputs and the reference's outputs: forward,
    prefill (s_max leaves room for both decode steps, the patch rows
    included) and the two decode steps with their caches."""
    arch = request.param
    rcfg, pcfg = _cfg(ref_configs, arch), _cfg(configs, arch)
    params = ref_params(MD.init(pcfg, "cpu", seed=1))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    batch = _batch(rcfg, np.random.default_rng(2))
    s_max = SEQ + 2 + (rcfg.vlm_num_patches if rcfg.family == "vlm" else 0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    full, _, _ = fast_jit(lambda p, b: RMD.forward(rcfg, p, b))(params, jb)
    plog, cache = fast_jit(lambda p, b: RMD.prefill(rcfg, p, b, s_max=s_max))(
        params, _prompt(jb))
    step = fast_jit(lambda p, c, t: RMD.decode_step(rcfg, p, c, t))
    steps = [(plog, cache)]
    for t in (SEQ - 2, SEQ - 1):
        steps.append(step(params, steps[-1][1], jb["tokens"][:, t]))
    return dict(arch=arch, rcfg=rcfg, pcfg=pcfg, params=params, model=model,
                batch=batch, s_max=s_max, full=full, steps=steps)


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
    for t, (want_logits, want_cache) in zip((SEQ - 2, SEQ - 1),
                                            run["steps"][1:]):
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
    np.testing.assert_allclose(_np(plog), _np(full[:, SEQ - 3]), atol=0.08,
                               rtol=0.05)
    for t in (SEQ - 2, SEQ - 1):
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
