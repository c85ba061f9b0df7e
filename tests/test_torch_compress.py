"""The port's compression pipeline against the reference's, on the reduced
qwen3-moe config (fp32, its own capacity dispatch, as the reference's CLI
calibrates) with converted parameters built by ``MD.init`` (ROADMAP R2):

* the copied pure-NumPy modules (clustering, merge in all four methods and
  the paper-literal T1, theory, plan, the reservoir schedule) give
  BIT-IDENTICAL results on the same inputs;
* ``compress_with_plan`` fed the reference's own calibration gives the
  reference's merged tables, remap and live counts bitwise (bf16 and int8
  plans, a heterogeneous mixed-method plan);
* end to end on the port's own capture (``CalibrationStream`` over the
  port's forward): the captured activations match the reference's to fp32
  sum order, the merged tables to ``rtol 1e-3`` (the least squares amplify
  the capture's last-bit differences by the condition number of P^T P), and
  the compressed model's loss to 1e-3 relative of the reference's;
* the port-compressed model served through the port ``Engine`` equals the
  reference ``Engine`` serving the reference-compressed model, token for
  token; the oracle forward; the CLI report.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as RCAL
from repro.core import clustering as RCL
from repro.core import compress as RCMP
from repro.core import merge as RMG
from repro.core import oracle as RORC
from repro.core import plan as RPLAN
from repro.core import theory as RTH
from repro.distributed.compression import shard_layer_solves as ref_solves
from repro.launch import compress as RLC
from repro.models import model as RMD
from repro_torch import convert
from repro_torch.core import calibration as CAL
from repro_torch.core import clustering as CL
from repro_torch.core import compress as CMP
from repro_torch.core import merge as MG
from repro_torch.core import oracle as ORC
from repro_torch.core import plan as PLAN
from repro_torch.core import theory as TH
from repro_torch.distributed.compression import shard_layer_solves
from repro_torch.launch import compress as LC
from repro_torch.models import model as MD

from _torch_port import (cfg_pair, port_engine, ref_engine, ref_tree_numpy,
                         run_trace, trace_requests)
from _torch_port import no_activation_mesh  # noqa: F401


def _same(a, b):
    """Bit-identical numpy trees (MergeResult fields, arrays, floats)."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def tables():
    """One layer's expert tables, calibration inputs and counts (numpy)."""
    rng = np.random.default_rng(0)
    N, d, f = 8, 24, 16
    wg = (rng.standard_normal((N, d, f)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((N, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((N, f, d)) * 0.2).astype(np.float32)
    X = rng.standard_normal((96, d)).astype(np.float32)
    counts = (rng.random(N) * 100).astype(np.float32)
    router = rng.standard_normal((d, N)).astype(np.float32)
    return wg, wu, wd, X, counts, router


# ---------------------------------------------------------------------------
# the copied NumPy modules: bit-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,kw", [
    ("mergemoe", {}), ("mergemoe", {"literal_t1": True}),
    ("msmoe", {"router": True}), ("msmoe", {}),
    ("average", {}), ("zipit", {})])
@pytest.mark.parametrize("M", [3, 8])
def test_merge_methods_bit_identical(tables, method, kw, M):
    wg, wu, wd, X, counts, router = tables
    kw = dict(kw)
    if kw.pop("router", False):
        kw["router"] = router
    fns = {"mergemoe": (MG.merge_mergemoe, RMG.merge_mergemoe),
           "msmoe": (MG.merge_msmoe, RMG.merge_msmoe),
           "average": (MG.merge_average, RMG.merge_average),
           "zipit": (MG.merge_zipit, RMG.merge_zipit)}
    mine, theirs = fns[method]
    _same(mine(wg, wu, wd, counts, X, M, **kw),
          theirs(wg, wu, wd, counts, X, M, **kw))
    _same(MG.merge_layer(method, wg, wu, wd, counts, X, M,
                         router=kw.get("router")),
          RMG.merge_layer(method, wg, wu, wd, counts, X, M,
                          router=kw.get("router")))


def test_clustering_and_theory_bit_identical(tables):
    wg, wu, wd, X, counts, router = tables
    for M in (1, 3, 5, 8):
        for kw in ({}, {"router": router, "metric": "router"}):
            _same(CL.cluster_experts(wg, wu, counts, M, **kw),
                  RCL.cluster_experts(wg, wu, counts, M, **kw))
        assign = CL.cluster_experts(wg, wu, counts, M)
        for fn in ("merge_weights", "mixing_matrix"):
            _same(getattr(CL, fn)(assign, counts, M),
                  getattr(RCL, fn)(assign, counts, M))
        _same(CL.summation_matrix(assign, M), RCL.summation_matrix(assign, M))
        A = CL.summation_matrix(assign, M)
        B = TH.optimal_B(assign, counts, M)
        _same(B, RTH.optimal_B(assign, counts, M))
        Y = np.random.default_rng(M).standard_normal((6, 8))
        W = Y.T @ Y
        _same(TH.objective(B, A, W, counts), RTH.objective(B, A, W, counts))
        r = np.abs(Y[0])
        _same(TH.output_error(Y, B, A, r), RTH.output_error(Y, B, A, r))
        _same(TH.quasi_frobenius(Y), RTH.quasi_frobenius(Y))


@pytest.mark.parametrize("arch_kind", ["reduced", "full"])
def test_plans_bit_identical(arch_kind):
    """Builders, budget planner, byte model, JSON round trip and the
    compressed config against the reference's, byte for byte."""
    rcfg, pcfg = cfg_pair("full", dtype="bfloat16", dispatch="dense")
    if arch_kind == "full":
        from repro import configs as rconfigs
        from repro_torch import configs as pconfigs
        rcfg, pcfg = (rconfigs.get("qwen3-moe-30b-a3b"),
                      pconfigs.get("qwen3-moe-30b-a3b"))
    N = rcfg.moe.n_experts
    stats = {l: np.random.default_rng(l).random(N) * 10
             for l in range(rcfg.n_layers)}
    builds = [
        lambda P, c: P.uniform(c, merged_experts=N // 2),
        lambda P, c: P.uniform(c, method="msmoe", merged_experts=2, split=0,
                               weight_dtype="int8"),
        lambda P, c: P.suffix(c, merged_experts=N // 4, frac=0.5),
        lambda P, c: P.for_target_ratio(c, target_ratio=1.05, stats=stats),
        lambda P, c: P.for_target_ratio(c, target_ratio=1.02),
    ]
    for build in builds:
        mine, theirs = build(PLAN, pcfg), build(RPLAN, rcfg)
        assert mine.to_json() == theirs.to_json()
        assert (json.dumps(mine.apply_to(pcfg).to_json_dict(), sort_keys=True)
                == json.dumps(theirs.apply_to(rcfg).to_json_dict(),
                              sort_keys=True))
        assert PLAN.plan_live_ratio(pcfg, mine) == RPLAN.plan_live_ratio(
            rcfg, theirs)
        back = PLAN.CompressionPlan.from_json(theirs.to_json())
        assert back == mine and back.requirements() == theirs.requirements()
    for wd in PLAN.WEIGHT_DTYPES:
        assert PLAN.expert_bytes(pcfg, wd) == RPLAN.expert_bytes(rcfg, wd)
    assert PLAN.available_methods() == RPLAN.available_methods()
    _same(PLAN.layer_importance(stats, [0, 1], N),
          RPLAN.layer_importance(stats, [0, 1], N))


def test_reservoir_functions_bit_identical():
    g = np.arange(0, 5000, 7, dtype=np.int64)
    for cap, seed, policy in ((64, 0, "reservoir"), (300, 11, "reservoir"),
                              (64, 3, "head")):
        _same(CAL.reservoir_slots(g, cap, seed, policy),
              RCAL.reservoir_slots(g, cap, seed, policy))
        states = []
        for mod in (CAL, RCAL):
            x = np.zeros((2, cap, 4), np.float32)
            sg = np.full(cap, -1, np.int64)
            rng = np.random.default_rng(seed)
            for lo in range(0, 5000, 700):             # chunks out of order
                gi = np.arange(lo, min(lo + 700, 5000), dtype=np.int64)[::-1]
                xi = rng.standard_normal((2, gi.size, 4)).astype(np.float32)
                mod.fold_tokens(x, sg, xi, gi, cap=cap, seed=seed,
                                policy=policy)
            states.append((x, sg))
        _same(states[0], states[1])
        parts = [(states[0][0] * (i + 1), states[0][1] - i) for i in range(3)]
        _same(CAL.merge_reservoirs(parts), RCAL.merge_reservoirs(parts))


def test_shard_layer_solves_gathers_in_layer_order():
    thunks = [lambda i=i: np.arange(i + 1) * 1.5 for i in range(7)]
    for n in (1, 3, 8):
        mine, stats = shard_layer_solves(thunks, n)
        theirs, _ = ref_solves(thunks, n)
        assert stats["n_shards"] == n
        for a, b in zip(mine, theirs):
            _same(a, b)
    with pytest.raises(ValueError):
        shard_layer_solves(thunks, 0)

    def boom():
        raise RuntimeError("solve failed")
    with pytest.raises(RuntimeError, match="solve failed"):
        shard_layer_solves([boom] * 3, 2)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _batches_np(cfg, n=2, B=2, S=48, seed=100):
    return [np.random.default_rng(seed + i).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32) for i in range(n)]


@pytest.fixture(scope="module")
def pair():
    """Reference params and the port model on the reduced fp32 config with
    its own capacity dispatch, calibration batches, and the reference's
    capture."""
    rcfg, pcfg = cfg_pair("full", dtype="float32", dispatch="dense")
    params = RMD.init(rcfg, jax.random.PRNGKey(0))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    toks = _batches_np(rcfg)
    rstream = RCAL.CalibrationStream(rcfg, params).consume(
        [{"tokens": jnp.asarray(t)} for t in toks])
    return rcfg, params, pcfg, model, toks, rstream


class _Fed:
    """The reference's captured calibration handed to the port's
    executor."""

    def __init__(self, rstream):
        self.n_tokens = rstream.n_tokens
        self._r = rstream

    def layer(self, l):
        c = self._r.layer(l)
        return CAL.LayerCalibration(x=c.x, counts=c.counts)


def _plans(P, cfg):
    N = cfg.moe.n_experts
    return {
        "uniform": P.uniform(cfg, merged_experts=N // 2, split=1),
        "int8": P.uniform(cfg, merged_experts=N // 2, split=0,
                          weight_dtype="int8"),
        "mixed": P.CompressionPlan((P.LayerSpec(0, "mergemoe", 3),
                                    P.LayerSpec(1, "msmoe", 5))),
    }


def _check_tables(pmodel, rparams, int8):
    rmoe = rparams["stack_c"]["moe"]
    for i, block in enumerate(pmodel.stack_c):
        moe = block.moe
        if int8:
            for key in ("wg", "wu", "wd", "wg_scale", "wu_scale", "wd_scale"):
                np.testing.assert_array_equal(
                    getattr(moe.qexp, key).numpy(),
                    np.asarray(rmoe["qexp"][key][i]))
        else:
            for key in ("wg", "wu", "wd"):
                np.testing.assert_array_equal(getattr(moe, key).numpy(),
                                              np.asarray(rmoe[key][i]))
        np.testing.assert_array_equal(moe.remap.numpy(),
                                      np.asarray(rmoe["remap"][i]))
        assert int(moe.live) == int(np.asarray(rmoe["live"])[i])


@pytest.mark.parametrize("name", ["uniform", "int8", "mixed"])
def test_compress_with_plan_on_the_reference_capture_is_bitwise(pair, name):
    rcfg, params, pcfg, model, _, rstream = pair
    rnc, rnp, rinfo = RCMP.compress_with_plan(rcfg, params,
                                              _plans(RPLAN, rcfg)[name],
                                              stream=rstream)
    pnc, pnm, pinfo = CMP.compress_with_plan(pcfg, model,
                                             _plans(PLAN, pcfg)[name],
                                             stream=_Fed(rstream))
    assert (json.dumps(pnc.to_json_dict(), sort_keys=True)
            == json.dumps(rnc.to_json_dict(), sort_keys=True))
    _check_tables(pnm, rnp, int8=name == "int8")
    for key in ("bytes_original", "bytes_compressed", "bytes_padded",
                "compression_ratio", "per_layer", "resid", "plan",
                "merged_per_layer", "layers_merged", "calib_tokens",
                "method", "weight_dtype", "n_experts", "merged_experts"):
        assert pinfo[key] == rinfo[key], key
    # the prefix stack and the embedding are the original model's
    if pnc.moe_split > 0:
        assert torch.equal(pnm.stack[0].moe.wg, model.stack[0].moe.wg)
    assert torch.equal(pnm.embed.tok, model.embed.tok)


def test_port_capture_and_end_to_end_compression(pair):
    rcfg, params, pcfg, model, toks, rstream = pair
    stream = CAL.CalibrationStream(pcfg, model).consume(
        [{"tokens": torch.from_numpy(t)} for t in toks])
    assert stream.n_tokens == rstream.n_tokens == 2 * 2 * 48
    for l in range(rcfg.n_layers):
        np.testing.assert_array_equal(stream.layer(l).counts,
                                      rstream.layer(l).counts)
        np.testing.assert_allclose(stream.layer(l).x, rstream.layer(l).x,
                                   rtol=1e-4, atol=1e-5)
    legacy = CAL.collect(pcfg, model, [{"tokens": torch.from_numpy(t)}
                                       for t in toks])
    np.testing.assert_array_equal(legacy[1].x, stream.layer(1).x)

    rbatches = [{"tokens": jnp.asarray(t)} for t in toks]
    rnc, rnp, _ = RCMP.compress_model(rcfg, params, merged_experts=4, split=1,
                                      batches=rbatches)
    pnc, pnm, _ = CMP.compress_model(
        pcfg, model, merged_experts=4, split=1,
        batches=[{"tokens": torch.from_numpy(t)} for t in toks])
    rmoe = rnp["stack_c"]["moe"]
    moe = pnm.stack_c[0].moe
    np.testing.assert_array_equal(moe.remap.numpy(),
                                  np.asarray(rmoe["remap"][0]))
    for key in ("wg", "wu", "wd"):
        want = np.asarray(rmoe[key][0])
        np.testing.assert_allclose(getattr(moe, key).numpy(), want, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want).max()))
    ev = _batches_np(rcfg, n=2, seed=900)
    rl = np.mean([float(RMD.loss(rnc, rnp, {"tokens": jnp.asarray(t)})[0])
                  for t in ev])
    pl_ = np.mean([float(MD.loss(pnc, pnm, {"tokens": torch.from_numpy(t)})[0])
                   for t in ev])
    np.testing.assert_allclose(pl_, rl, rtol=1e-3)


def test_port_compressed_model_served_equals_the_reference(pair):
    """The model the port compressed (from the reference's capture, so its
    tables are the reference's bitwise) served through the port Engine gives
    the reference Engine's tokens on the staggered trace (fp32, gather)."""
    rcfg, params, pcfg, model, _, rstream = pair
    rnc, rnp, _ = RCMP.compress_with_plan(rcfg, params,
                                          _plans(RPLAN, rcfg)["uniform"],
                                          stream=rstream)
    pnc, pnm, _ = CMP.compress_with_plan(pcfg, model,
                                         _plans(PLAN, pcfg)["uniform"],
                                         stream=_Fed(rstream))
    kw = dict(arch="qwen3-moe-30b-a3b", n_slots=3, s_max=24,
              prefill_buckets=(8, 16), decode_block=8, dispatch="gather")
    reqs = trace_requests(rcfg.vocab_size)
    want = run_trace(ref_engine(rnc, rnp, **kw), reqs)
    got = run_trace(port_engine(pnc, pnm, **kw), reqs)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == q["max_new_tokens"]
               for r, q in zip(got, reqs))


def test_oracle_forward_vs_reference(pair):
    rcfg, params, pcfg, model, toks, rstream = pair
    assigns, bweights = {}, {}
    for l in range(rcfg.n_layers):
        c = rstream.layer(l)
        assigns[l] = RCL.cluster_experts(
            np.asarray(params["stack"]["moe"]["wg"][l], np.float32),
            np.asarray(params["stack"]["moe"]["wu"][l], np.float32),
            c.counts, 4)
        bweights[l] = RCL.merge_weights(assigns[l], c.counts, 4)
    want = RORC.oracle_forward(rcfg, params, {"tokens": jnp.asarray(toks[0])},
                               assigns, bweights)
    got = ORC.oracle_forward(pcfg, model, {"tokens": torch.from_numpy(toks[0])},
                             assigns, bweights)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-5 * float(np.abs(want).max()))


def test_reference_tree_round_trips_the_model(pair):
    """``convert.unstacked_tree`` + ``stack_tree`` invert the bridge: the
    reference's own tree layout, and the model rebuilt from it equal."""
    rcfg, params, pcfg, model, _, _ = pair
    tree = convert.unstacked_tree(model)
    assert "stack" not in tree
    tree["stack"] = convert.stack_tree(model.stack)
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            ref_tree_numpy(params)):
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    back = convert.from_reference_params(tree, pcfg, "cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 back.state_dict().items()):
        assert torch.equal(a, b), name


def test_cli_report_and_what_is_not_ported(pair):
    rcfg, params, pcfg, model, _, _ = pair
    _, _, report = LC.run(cfg=pcfg, model=model, merged_experts=4, split=1,
                          calib_batches=1, eval_batches=1, device="cpu",
                          batch=2, seq=32)
    _, _, rreport = RLC.run("qwen3-moe-30b-a3b", merged_experts=4, split=1,
                            calib_batches=1, eval_batches=1, cfg=rcfg,
                            params=params)
    assert report.keys() == rreport.keys()
    assert report["calib_tokens"] == 64 and report["layers_merged"] == [1]
    assert report["bytes_compressed"] == rreport["bytes_compressed"]
    assert np.isfinite(report["loss_full"]) and np.isfinite(
        report["loss_compressed"])
    with pytest.raises(NotImplementedError, match="save-dir"):
        LC.run(cfg=pcfg, model=model, save_dir="/nonexistent", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        LC.run(cfg=pcfg, model=model, mesh_spec="data=2", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        CAL.CalibrationStream(pcfg, model, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        CMP.compress_with_plan(pcfg, model, _plans(PLAN, pcfg)["uniform"],
                               stream=_Fed(pair[5]), mesh=object())
