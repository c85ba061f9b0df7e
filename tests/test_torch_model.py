"""Model-level differentials: prefill -> insert -> decode logits of the
port against the reference on converted parameters (fp32, CPU), for the
uncompressed model, the merged split-stack form and a heterogeneous suffix;
the converter's shape and key checks; the config JSON round trip.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import config as ref_config
from repro.models import model as RMD
from repro_torch import configs, convert
from repro_torch.models import config as port_config
from repro_torch.models import model as MD

from _torch_port import cfg_pair, model_pair, ref_tree_numpy
from _torch_port import no_activation_mesh  # noqa: F401


def _close(got, want):
    want = np.asarray(want)
    # fp32, reduction order only, atol scaled to the logits
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["full", "merged", "hetero"])
def test_prefill_insert_decode_logits_vs_reference(kind):
    rcfg, params, pcfg, model = model_pair(kind)
    rng = np.random.default_rng(0)
    n_slots, s_max, Sb = 3, 16, 8
    toks = rng.integers(0, rcfg.vocab_size, (4, Sb)).astype(np.int32)
    lengths = np.array([8, 5, 3, 1], np.int32)
    # rows 0, 1 are real (slots 2 and 0); rows 2, 3 are admission pads whose
    # slot id is out of range: they must not touch the cache
    slots = np.array([2, 0, n_slots, n_slots], np.int32)

    rcache = RMD.init_slot_cache(rcfg, n_slots, s_max)
    rl, rk, rv = RMD.prefill_slots(rcfg, params, jnp.asarray(toks),
                                   jnp.asarray(lengths))
    rcache = RMD.insert_slots(rcache, jnp.asarray(slots), rk, rv,
                              jnp.asarray(lengths))

    cache = MD.init_slot_cache(pcfg, n_slots, s_max, "cpu")
    cache["k"][:, 1] = 7.0                       # sentinel in the untouched slot
    pl_, pk, pv = MD.prefill_slots(pcfg, model, torch.from_numpy(toks),
                                   torch.from_numpy(lengths))
    out = MD.insert_slots(cache, slots, pk, pv, torch.from_numpy(lengths))
    assert out is cache                          # in place
    _close(pl_, rl)
    assert cache["pos"].tolist() == [5, 0, 8]
    assert bool((cache["k"][:, 1] == 7.0).all())  # pad rows wrote nothing
    cache["k"][:, 1] = 0.0
    _close(cache["k"], rcache["k"])
    _close(cache["v"], rcache["v"])

    tok = np.array([3, 9, 200], np.int32)
    active = np.array([True, False, True])
    for _ in range(4):
        rlog, rcache = RMD.decode_step_slots(rcfg, params, rcache,
                                             jnp.asarray(tok),
                                             jnp.asarray(active))
        plog, cache = MD.decode_step_slots(pcfg, model, cache,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(active))
        _close(plog[active], np.asarray(rlog)[active])
        assert plog.dtype == torch.float32
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        tok = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)
        np.testing.assert_array_equal(
            plog[active].argmax(-1).numpy(), tok[active])


def test_model_layout_split_stack_and_hetero_live():
    _, _, _, merged = model_pair("merged")
    assert len(merged.stack) == 1 and len(merged.stack_c) == 1
    assert merged.stack[0].moe.wg.shape[0] == 8
    assert merged.stack_c[0].moe.wg.shape[0] == 4
    _, _, _, het = model_pair("hetero")
    assert not hasattr(het, "stack") and len(het.stack_c) == 2
    assert [int(b.moe.live) for b in het.stack_c] == [4, 3]
    assert het.stack_c[1].moe.remap.tolist() == [i % 3 for i in range(8)]
    assert all(not p.requires_grad for p in het.parameters())
    assert het.stack_c[1].moe.remap.dtype == torch.int32


def test_converter_rejects_missing_extra_and_misshapen_leaves():
    rcfg, pcfg = cfg_pair("merged")
    tree = ref_tree_numpy(RMD.init(rcfg, jax.random.PRNGKey(1)))
    convert.from_reference_params(tree, pcfg, "cpu")          # fits

    missing = copy.deepcopy(tree)
    del missing["stack_c"]["moe"]["remap"]
    with pytest.raises(ValueError, match="missing leaves.*stack_c.moe.remap"):
        convert.from_reference_params(missing, pcfg, "cpu")

    extra = copy.deepcopy(tree)
    extra["stack"]["attn"]["bq"] = np.zeros((1, 64), np.float32)
    with pytest.raises(ValueError, match="unexpected leaves.*stack.attn.bq"):
        convert.from_reference_params(extra, pcfg, "cpu")

    bad = copy.deepcopy(tree)
    bad["stack_c"]["moe"]["wg"] = bad["stack_c"]["moe"]["wg"][:, :3]
    with pytest.raises(ValueError, match="stack_c.moe.wg.*shape"):
        convert.from_reference_params(bad, pcfg, "cpu")

    layers = copy.deepcopy(tree)
    layers["stack"]["ln1"]["scale"] = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError, match="layer"):
        convert.from_reference_params(layers, pcfg, "cpu")

    # the uncompressed config does not fit a compressed tree
    with pytest.raises(ValueError, match="unexpected leaves"):
        convert.from_reference_params(tree, cfg_pair("full")[1], "cpu")


def test_converter_dtype_and_exact_bf16_round_trip():
    rcfg, pcfg = cfg_pair("full", dtype="bfloat16")
    params = RMD.init(rcfg, jax.random.PRNGKey(2))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    wg = model.stack[1].moe.wg
    assert wg.dtype == torch.bfloat16
    assert model.stack[1].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        wg.float().numpy(),
        np.asarray(params["stack"]["moe"]["wg"][1].astype(jnp.float32)))
    as32 = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu",
                                         dtype=torch.float32)
    assert as32.stack[0].attn.wq.dtype == torch.float32
    assert as32.cfg.dtype == "float32"


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_json_round_trip_equals_reference(arch):
    r, p = ref_configs.get(arch), configs.get(arch)
    assert p.to_json_dict() == r.to_json_dict()
    assert p.reduced().to_json_dict() == r.reduced().to_json_dict()
    text = json.dumps(r.to_json_dict())
    assert port_config.config_from_dict(json.loads(text)) == p
    assert ref_config.config_from_dict(
        json.loads(json.dumps(p.to_json_dict()))) == r
    assert p.param_count() == r.param_count()
    assert configs.ALIASES == ref_configs.ALIASES


def test_compressed_config_views_equal_reference():
    r, p = cfg_pair("hetero")
    assert p.to_json_dict() == r.to_json_dict()
    assert p.live_experts_per_suffix_layer() == (4, 3)
    r, p = cfg_pair("merged")
    assert p.to_json_dict() == r.to_json_dict()
    assert p.param_dtype == torch.float32
    dense = configs.get("yi-34b")
    from repro_torch.core.errors import TechniqueInapplicable
    with pytest.raises(TechniqueInapplicable):
        dense.compressed(4)
