"""Checkpoints and compressed artifacts (``repro_torch.ckpt``) against the
reference's ``repro.ckpt.checkpoint``, on the CPU.

What is held, for the reduced fp32 configs of ``_torch_port`` (``full``;
``merged``, M = 4 from layer 1; ``hetero``, live 4 and 3 from layer 0) and
their int8 forms (the reference's ``quantize_model_experts``: ``int8`` on
``merged``, both stacks; ``hetero_int8``, ragged int8 tables):

* ``tree_digest`` and the treedef bytes equal the reference's for the same
  tree (and for a tree of lists, tuples, ``None`` and bf16 leaves);
* a reference artifact loads into the port bitwise, config and extras
  equal; a port artifact's ``.npy`` files are byte for byte the reference's,
  its ``meta.json`` equal as parsed JSON, and the reference loads it
  bitwise. Every comparison is with the reference's LOADER, not the saved
  tree: ``init`` of the hetero config leaves non-zero pad rows, which an
  artifact does not store and a load pads back with zeros;
* the port's compression entry point (``launch.compress.run(save_dir=)``
  and ``--save-dir``) round-trips bitwise, pad rows included;
* the reference's own checkpoint cases (keep-N, an uncommitted ``.tmp``, a
  flipped byte, ``latest_step``, the async manager, the refusals);
* ``Engine.from_checkpoint`` gives the reference's ``Engine.from_checkpoint``
  tokens on the same reference-written directory, and an engine with
  ``spec_draft=<dir>`` the tokens and acceptance counters of the same
  engine given the draft in-process.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCK
from repro.core import quant as RQ
from repro.models import numerics as ref_numerics
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro_torch import convert
from repro_torch.ckpt import checkpoint as CK
from repro_torch.ckpt import treedef as TD
from repro_torch.core import errors as ERR
from repro_torch.core import plan as PLAN
from repro_torch.launch import compress as LC
from repro_torch.serving import Engine, EngineConfig

from _torch_port import (no_activation_mesh, one_torch_thread,  # noqa: F401
                         engine_kwargs, model_pair, ref_tree_numpy,
                         run_trace, trace_requests)

KINDS = ("full", "merged", "hetero", "int8", "hetero_int8")
COMPRESSED = KINDS[1:]
#: a plan and a report as the compression pipeline records them
PLAN_DICT = {"version": 1, "weight_dtype": "bf16",
             "specs": [{"layer": 1, "method": "mergemoe",
                        "merged_experts": 4}]}
REPORT = {"method": "mergemoe", "merged_per_layer": [4], "mesh": None,
          "compression_ratio": 1.5}


@pytest.fixture(scope="module")
def pairs():
    """kind -> (ref cfg, ref params, port cfg, port model on the CPU)."""
    out = {}
    for kind in KINDS:
        base = kind.replace("_int8", "").replace("int8", "merged")
        rcfg, params, pcfg, _ = model_pair(base)
        if "int8" in kind:
            params = RQ.quantize_model_experts(params)
        model = convert.from_reference_params(ref_tree_numpy(params), pcfg,
                                              "cpu")
        out[kind] = (rcfg, params, pcfg, model)
    return out


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as uint16), for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_trees_bitwise(port_tree, ref_tree):
    got = TD.leaves_with_path(port_tree)
    want = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert [str(p) for p, _ in got] == [str(p) for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert _dtype(a) == str(b.dtype), path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(path))


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _save_ref(kind, pairs, d):
    rcfg, params, _, _ = pairs[kind]
    if kind == "full":
        return RCK.save(d, 0, params, extras={"note": "plain"})
    return RCK.save_compressed(d, rcfg, params, plan=PLAN_DICT, report=REPORT)


def _save_port(kind, pairs, d):
    _, _, pcfg, model = pairs[kind]
    if kind == "full":
        return CK.save(d, 0, convert.reference_tree(model),
                       extras={"note": "plain"})
    return CK.save_compressed(d, pcfg, model, plan=PLAN_DICT, report=REPORT)


# ---------------------------------------------------------------------------
# the digest and the treedef
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_digest_and_treedef_equal_the_reference(pairs, kind):
    _, params, _, model = pairs[kind]
    tree = convert.reference_tree(model)
    assert CK.tree_digest(tree) == RCK.tree_digest(params)
    assert TD.encode(tree) == \
        jax.tree_util.tree_structure(params).serialize_using_proto()


def _odd_tree():
    """Lists, tuples, None, an empty dict, bf16 / int8 / int32 leaves."""
    rng = np.random.default_rng(1)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    return {"z": [jnp.asarray(f, jnp.bfloat16),
                  (jnp.arange(4, dtype=jnp.int8), None),
                  {}],
            "a": (jnp.asarray(f), [jnp.asarray(7, jnp.int32)]),
            "n": None, "e": ()}


def _port_leaf(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_digest_treedef_and_files_of_lists_tuples_and_none(tmp_path):
    ref = _odd_tree()
    port = jax.tree.map(_port_leaf, ref)
    assert CK.tree_digest(port) == RCK.tree_digest(ref)
    raw = jax.tree_util.tree_structure(ref).serialize_using_proto()
    assert TD.encode(port) == raw
    back = TD.unflatten(raw, TD.leaves(port))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    RCK.save(tmp_path / "ref", 3, ref)
    CK.save(tmp_path / "port", 3, port)
    for f in sorted((tmp_path / "ref" / "step_00000003").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / "step_00000003"
                                  / f.name).read_bytes(), f.name
    got, _ = CK.load(tmp_path / "ref", device="cpu")
    _assert_trees_bitwise(got, ref)


def test_treedef_codec_refuses_what_it_does_not_know():
    raw = jax.tree_util.tree_structure({"a": [1, 2]}).serialize_using_proto()
    with pytest.raises(ValueError, match="kind"):
        TD.decode(raw.replace(b"\x10\x05", b"\x10\x07"))     # dict -> 7
    with pytest.raises(ValueError, match="leaves"):
        TD.unflatten(raw, [1])
    with pytest.raises(ValueError, match="leaves"):
        TD.unflatten(raw, [1, 2, 3])
    with pytest.raises(TypeError, match="OrderedDict"):
        from collections import OrderedDict
        TD.encode({"a": OrderedDict(b=1)})


# ---------------------------------------------------------------------------
# artifacts cross both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_reference_artifact_loads_into_the_port_bitwise(pairs, kind,
                                                        tmp_path):
    rcfg, _, pcfg, _ = pairs[kind]
    _save_ref(kind, pairs, tmp_path)
    if kind == "full":
        got, extras = CK.load(tmp_path, device="cpu")
        want, want_extras = RCK.load(tmp_path)
        _assert_trees_bitwise(got, want)
        assert extras == want_extras
        return
    cfg, tree, art = CK.load_compressed_tree(tmp_path)
    rcfg2, rtree, rart = RCK.load_compressed(tmp_path)
    _assert_trees_bitwise(tree, rtree)
    assert cfg.to_json_dict() == rcfg2.to_json_dict() == rcfg.to_json_dict()
    assert art == rart
    cfg3, model, art3 = CK.load_compressed(tmp_path, device="cpu")
    assert cfg3 == cfg == pcfg and art3 == art
    _assert_trees_bitwise(convert.reference_tree(model), rtree)


@pytest.mark.parametrize("kind", KINDS)
def test_port_artifact_is_the_reference_artifact(pairs, kind, tmp_path):
    ref_dir = _save_ref(kind, pairs, tmp_path / "ref")
    port_dir = _save_port(kind, pairs, tmp_path / "port")
    names = sorted(f.name for f in ref_dir.iterdir())
    assert names == sorted(f.name for f in port_dir.iterdir())
    for name in names:
        if name.endswith(".npy") or name == "COMMIT":
            assert (port_dir / name).read_bytes() == \
                (ref_dir / name).read_bytes(), name
    assert json.loads((port_dir / "meta.json").read_text()) == \
        json.loads((ref_dir / "meta.json").read_text())
    if kind == "full":
        got, _ = RCK.load(tmp_path / "port")
        want, _ = RCK.load(tmp_path / "ref")
    else:
        got = RCK.load_compressed(tmp_path / "port")[1]
        want = RCK.load_compressed(tmp_path / "ref")[1]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(path))


def test_bf16_leaves_cross_as_fp32_files_exactly(pairs, tmp_path):
    """A bf16 model: fp32 ``.npy`` files with ``"dtype": "bfloat16"``, the
    digest over the two-byte bits, the same files as the reference's."""
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 else a, pairs["merged"][1])
    tree = jax.tree.map(_port_leaf, params)
    assert tree["stack_c"]["moe"]["wg"].dtype == torch.bfloat16
    assert CK.tree_digest(tree) == RCK.tree_digest(params)
    d_ref = RCK.save(tmp_path / "ref", 0, params)
    d_port = CK.save(tmp_path / "port", 0, tree)
    meta = json.loads((d_port / "meta.json").read_text())
    assert "bfloat16" in {leaf["dtype"] for leaf in meta["leaves"]}
    for f in sorted(d_ref.iterdir()):
        assert f.read_bytes() == (d_port / f.name).read_bytes(), f.name
    got, _ = CK.load(tmp_path / "ref", device="cpu")
    _assert_trees_bitwise(got, params)


# ---------------------------------------------------------------------------
# the port's compression writes artifacts
# ---------------------------------------------------------------------------

def _plans(pcfg):
    return {
        "uniform_split_1": PLAN.uniform(pcfg, merged_experts=4, split=1),
        "hetero_split_0": PLAN.CompressionPlan((
            PLAN.LayerSpec(0, "mergemoe", 4), PLAN.LayerSpec(1, "msmoe", 3))),
        "int8_split_1": PLAN.uniform(pcfg, merged_experts=4, split=1,
                                     weight_dtype="int8"),
    }


@pytest.mark.parametrize("plan", ["uniform_split_1", "hetero_split_0",
                                  "int8_split_1"])
def test_compress_run_save_dir_round_trips(pairs, plan, tmp_path):
    _, _, pcfg, model = pairs["full"]
    the_plan = _plans(pcfg)[plan]
    ncfg, nmodel, report = LC.run(cfg=pcfg, model=model, plan=the_plan,
                                  calib_batches=1, eval_batches=1,
                                  device="cpu", batch=2, seq=32,
                                  save_dir=tmp_path)
    cfg, back, art = CK.load_compressed(tmp_path, device="cpu")
    assert cfg == ncfg
    want, got = nmodel.state_dict(), back.state_dict()
    assert want.keys() == got.keys()
    for name, t in want.items():
        assert t.dtype == got[name].dtype and torch.equal(t, got[name]), name
    assert art["format"] == 1 and art["mesh"] is None
    assert PLAN.CompressionPlan.from_json_dict(art["plan"]) == the_plan
    assert art["report"]["merged_per_layer"] == report["merged_per_layer"]
    assert art["report"]["bytes_compressed"] == report["bytes_compressed"]
    if plan == "hetero_split_0":     # layer 1's pad row stored nowhere
        meta = json.loads((tmp_path / "step_00000000" /
                           "meta.json").read_text())
        shapes = [tuple(leaf["shape"]) for leaf in meta["leaves"]]
        f = pcfg.moe.d_ff_expert
        assert (3, pcfg.d_model, f) in shapes
        assert (2, 4, pcfg.d_model, f) not in shapes


def test_compress_cli_save_dir_boots_an_engine(tmp_path, capsys):
    LC.main(["--device", "cpu", "--merged-experts", "4", "--split", "1",
             "--calib-batches", "1", "--eval-batches", "1",
             "--save-dir", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    eng = Engine.from_checkpoint(tmp_path, device="cpu")
    assert eng.cfg.moe_merged == 4 and eng.cfg.moe_split == 1
    assert eng.ec.arch == eng.cfg.name and not eng.ec.reduced
    assert eng.artifact["report"]["bytes_compressed"] == \
        report["bytes_compressed"]
    r = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.run()
    assert len(r.out_tokens) == 3


# ---------------------------------------------------------------------------
# the reference's checkpoint cases
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def test_roundtrip_with_bf16_and_extras(tmp_path):
    CK.save(tmp_path, 5, _tree(), extras={"note": "hi"})
    t, extras = CK.load(tmp_path, device="cpu")
    assert extras == {"note": "hi"}
    assert t["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(TD.leaves(t), TD.leaves(_tree())):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_n_gc_and_latest_step(tmp_path):
    assert CK.latest_step(tmp_path / "missing") is None
    for s in range(6):
        CK.save(tmp_path, s, _tree(), keep=2)
    assert CK.latest_step(tmp_path) == 5
    assert sorted(d.name for d in tmp_path.glob("step_????????")) == \
        ["step_00000004", "step_00000005"]
    t, _ = CK.load(tmp_path, step=4, device="cpu")
    assert int(t["b"]["d"]) == 3
    with pytest.raises(FileNotFoundError):
        CK.load(tmp_path / "missing", device="cpu")


def test_partial_write_ignored(tmp_path):
    CK.save(tmp_path, 1, _tree())
    bad = tmp_path / "step_00000002.tmp"        # a crash mid-write
    bad.mkdir()
    (bad / "meta.json").write_text("{}")
    assert CK.latest_step(tmp_path) == 1
    t, _ = CK.load(tmp_path, device="cpu")
    assert "a" in t
    CK.save(tmp_path, 3, _tree())               # the next save collects it
    assert not bad.exists()


def test_flipped_byte_raises_and_loads_unverified(pairs, tmp_path):
    d = _save_port("hetero", pairs, tmp_path)
    leaf = d / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(ERR.ArtifactCorruptError, match="digest"):
        CK.load_compressed(tmp_path, device="cpu")
    with pytest.raises(ERR.ArtifactCorruptError):
        CK.load(tmp_path, device="cpu")
    cfg, model, _ = CK.load_compressed(tmp_path, verify=False, device="cpu")
    assert cfg == pairs["hetero"][2]
    # the reference refuses the same file
    with pytest.raises(Exception, match="digest"):
        RCK.load(tmp_path)


def test_async_manager_equals_sync(tmp_path):
    tree = _tree()
    mgr = CK.CheckpointManager(tmp_path / "async", keep=2, async_save=True)
    mgr.save(1, tree)
    tree["a"].add_(100)                 # the snapshot was taken at save()
    mgr.save(2, tree)
    assert mgr.latest_step() == 2
    sync = CK.CheckpointManager(tmp_path / "sync", keep=2)
    sync.save(1, _tree())
    for f in sorted((tmp_path / "sync" / "step_00000001").iterdir()):
        assert f.read_bytes() == (tmp_path / "async" / "step_00000001"
                                  / f.name).read_bytes(), f.name
    t, _ = mgr.restore(step=2, device="cpu")
    assert torch.equal(t["a"], _tree()["a"] + 100)


def test_load_compressed_refuses_a_plain_checkpoint(tmp_path):
    CK.save(tmp_path, 0, {"w": torch.ones((2,))})
    with pytest.raises(ValueError, match="plain checkpoint"):
        CK.load_compressed(tmp_path, device="cpu")


def test_save_compressed_refuses_an_uncompressed_model(pairs, tmp_path):
    _, _, pcfg, model = pairs["full"]
    with pytest.raises(ValueError, match="not compressed"):
        CK.save_compressed(tmp_path, pcfg, model)


def test_loading_onto_the_card_is_never_answered_by_the_cpu(pairs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts "
                    "without one")
    _save_port("merged", pairs, tmp_path)
    for call in (lambda: CK.load(tmp_path),
                 lambda: CK.load_compressed(tmp_path),
                 lambda: Engine.from_checkpoint(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# engines boot from artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["merged", "hetero", "int8"])
def test_engine_from_checkpoint_equals_the_reference(pairs, kind, tmp_path):
    rcfg = pairs[kind][0]
    _save_ref(kind, pairs, tmp_path)
    reqs = trace_requests(rcfg.vocab_size)
    kw = engine_kwargs()
    ref = RefEngine.from_checkpoint(
        tmp_path, ec=RefEngineConfig(trace_guard="off", **kw))
    ref_numerics.set_activation_mesh(None)
    want = [list(r.out_tokens) for r in run_trace(ref, reqs)]
    eng = Engine.from_checkpoint(tmp_path, ec=EngineConfig(**kw),
                                 device="cpu")
    assert eng.artifact == ref.artifact
    assert eng.expert_weight_dtypes() == ref.expert_weight_dtypes()
    assert [list(r.out_tokens) for r in run_trace(eng, reqs)] == want


@pytest.mark.parametrize("kind", ["merged", "hetero", "int8"])
def test_spec_draft_directory_equals_the_in_process_draft(pairs, kind,
                                                          tmp_path):
    _, _, pcfg, model = pairs["full"]
    _, _, dcfg, draft = pairs[kind]
    CK.save_compressed(tmp_path, dcfg, draft, plan=PLAN_DICT, report=REPORT)
    reqs = trace_requests(pcfg.vocab_size)
    kw = dict(engine_kwargs(), spec_k=3, s_max=32)
    engines = {
        "dir": Engine(EngineConfig(spec_draft=str(tmp_path), **kw), cfg=pcfg,
                      params=model, device="cpu"),
        "in_process": Engine(EngineConfig(**kw), cfg=pcfg, params=model,
                             draft_cfg=dcfg, draft_params=draft,
                             device="cpu")}
    out = {name: [list(r.out_tokens) for r in run_trace(e, reqs)]
           for name, e in engines.items()}
    assert out["dir"] == out["in_process"]
    a, b = engines["dir"], engines["in_process"]
    assert a.spec and a.draft_cfg == b.draft_cfg
    assert a.draft_artifact["report"] == REPORT and b.draft_artifact is None
    for key in ("tokens_drafted", "tokens_accepted", "tokens_rolled_back",
                "tokens_out"):
        assert a.counters[key] == b.counters[key], key
    assert a.counters["tokens_drafted"] > 0
