"""Step functions of the port against the reference's (fp32, CPU): the
admission padding policy, greedy sampling (temperature > 0:
``test_torch_sampling.py``), the single decode step and the
fused K-step block with its packed (token, emitted, finite) lanes; plus the
environment probe and the kernel build helper as far as a host without a
CUDA compiler can show them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as RST
from repro.models import model as RMD
from repro_torch import env
from repro_torch.kernels import _build
from repro_torch.launch import steps as ST
from repro_torch.models import model as MD

from _torch_port import model_pair
from _torch_port import no_activation_mesh  # noqa: F401


@pytest.mark.parametrize("buckets,s_max,n_slots", [
    ((16, 32, 64), 128, 4), ((8, 16), 24, 3), ((64, 128, 256), 512, 8),
    ((), 10, 1), ((100,), 64, 5), ((7, 7, 3), 50, 16),
])
def test_admission_padding_policy_equals_reference(buckets, s_max, n_slots):
    assert ST.admit_pad_shapes(buckets, s_max) == \
        RST.admit_pad_shapes(buckets, s_max)
    assert ST.admit_pad_shapes(buckets, s_max)[-1] == s_max


def test_sample_tokens_greedy_and_first_index_ties():
    logits = np.random.default_rng(0).standard_normal((5, 33)).astype(
        np.float32)
    logits[2, [4, 9]] = logits[2].max() + 1.0             # an exact tie
    want = RST.sample_tokens(jnp.asarray(logits), 0.0, None, None)
    got = ST.sample_tokens(torch.from_numpy(logits), 0.0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[2]) == 4


@pytest.fixture(scope="module")
def admitted():
    """Both frameworks' models with three slots prefilled identically."""
    rcfg, params, pcfg, model = model_pair("merged")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, rcfg.vocab_size, (3, 8)).astype(np.int32)
    lengths = np.array([8, 4, 6], np.int32)
    slots = np.array([0, 1, 2], np.int32)
    _, rg, rcache = RST.make_slot_admit(rcfg)(
        params, RMD.init_slot_cache(rcfg, 3, 24), jnp.asarray(toks),
        jnp.asarray(lengths), jnp.asarray(slots))
    _, pg, pcache = ST.make_slot_admit(pcfg)(
        model, MD.init_slot_cache(pcfg, 3, 24, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(lengths), slots)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    return rcfg, params, rcache, pcfg, model, pcache, np.array(rg)


def test_slot_decode_aux_lanes(admitted):
    rcfg, params, rcache, pcfg, model, pcache, first = admitted
    pcache = {k: v.clone() for k, v in pcache.items()}
    act = np.array([True, True, False])
    rl, raux, _ = RST.make_slot_decode(rcfg)(
        params, rcache, jnp.asarray(first), jnp.asarray(act),
        jnp.zeros((3,), bool))
    pl_, paux, out = ST.make_slot_decode(pcfg)(
        model, pcache, torch.from_numpy(first), torch.from_numpy(act))
    assert out is pcache and paux.dtype == torch.int32
    np.testing.assert_array_equal(paux.numpy()[act], np.asarray(raux)[act])
    want = np.asarray(rl)[act]
    # fp32, reduction order only, atol scaled to the logits
    np.testing.assert_allclose(pl_.numpy()[act], want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


def test_fused_block_equals_reference_block(admitted):
    """K fused steps with a slot that runs out of budget and one that hits
    its eos: tokens, emitted flags and the finite lane of every step."""
    rcfg, params, rcache, pcfg, model, pcache, first = admitted
    pcache = {k: v.clone() for k, v in pcache.items()}
    K = 6
    act = np.array([True, True, True])
    rem = np.array([2, 9, 9], np.int32)
    free_run, _, _ = RST.make_slot_decode_multi(rcfg, K)(
        params, rcache, jnp.asarray(first), jnp.asarray(act),
        jnp.asarray(rem), jnp.full((3,), -1, jnp.int32),
        jnp.zeros((3, 2), jnp.uint32), jnp.zeros((3,), bool))
    eos = np.array([-1, int(np.asarray(free_run)[3, 1, 0]), -1], np.int32)
    rblock, ract, rc = RST.make_slot_decode_multi(rcfg, K)(
        params, rcache, jnp.asarray(first), jnp.asarray(act),
        jnp.asarray(rem), jnp.asarray(eos), jnp.zeros((3, 2), jnp.uint32),
        jnp.zeros((3,), bool))
    pblock, pact, pc = ST.make_slot_decode_multi(pcfg, K)(
        model, pcache, torch.from_numpy(first), torch.from_numpy(act),
        torch.from_numpy(rem), torch.from_numpy(eos))
    rblock, pblock = np.asarray(rblock), pblock.numpy()
    assert pblock.shape == (K, 3, 3) and pblock.dtype == np.int32
    np.testing.assert_array_equal(pblock[:, :, 1], rblock[:, :, 1])
    emitted = rblock[:, :, 1].astype(bool)
    np.testing.assert_array_equal(pblock[:, :, 0][emitted],
                                  rblock[:, :, 0][emitted])
    assert (pblock[:, :, 2] == 1).all() and (rblock[:, :, 2] == 1).all()
    assert emitted[:, 0].sum() == 2 and emitted[:, 1].sum() <= 4
    np.testing.assert_array_equal(pact.numpy(), np.asarray(ract))
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))


def test_env_probe_on_a_host_without_a_gpu():
    info = env.probe()
    assert {"torch", "cuda_available", "device_name", "compute_capability",
            "nvidia_smi", "nvcc", "mm_out_dtype"} <= set(info)
    if not info["cuda_available"]:
        assert info["device_name"] is None and info["mm_out_dtype"] is None


def test_build_helper_names_libraries_by_source_hash(tmp_path, monkeypatch):
    a = _build._lib_path("gather_swiglu")
    assert a.parent == _build.build_dir() and a.name.startswith(
        "libgather_swiglu-") and a.suffix == ".so"
    assert set(_build.KERNEL_SOURCES) == {
        p.stem for p in _build.CSRC.glob("*.cu")}
    # an edited source gets another library name, so it is rebuilt
    copy = tmp_path / "csrc"
    copy.mkdir()
    for p in _build.CSRC.iterdir():
        (copy / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build._lib_path("gather_swiglu").name == a.name
    (copy / "moe_swiglu.cuh").write_text("// edited\n")
    assert _build._lib_path("gather_swiglu").name != a.name


def test_build_without_nvcc_raises(monkeypatch):
    import shutil
    if shutil.which("nvcc"):
        pytest.skip("this check is for a host without the CUDA compiler")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
