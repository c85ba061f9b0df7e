"""Engine snapshots of the port (``Engine.snapshot`` / ``save_snapshot`` /
``restore``, ``snapshot_every_steps``), held as the reference's
``tests/test_snapshot_restore.py`` holds its own, and against the
reference's snapshots.

* A mid-trace snapshot (two slots decoding, one request pending) restored
  into a FRESH engine finishes the trace token for token as the
  uninterrupted run, and so does the engine that kept running: dense cache
  (greedy and at temperature 0.7), paged pool with a prefix registered
  (the restored allocator drains clean), and speculative rounds with a
  random draft (rollbacks in flight).
* The host part is JSON-safe; ``save_snapshot`` commits through
  ``ckpt.checkpoint.save`` in the reference's format, ``restore(dir)``
  verifies the ``tree_digest``, and a leaf corrupted by the port's
  ``FaultPlan.corrupt`` is refused (``verify=False`` loads it anyway).
* A snapshot DIRECTORY written by the reference engine (fp32, reduced
  config, greedy; dense cache and paged pool) restores into the port's
  engine, which finishes with the reference's tokens. The layouts differ in
  rows no slot reads: the port's dense cache has ``rows`` = ``s_max``
  rounded up to ``kv_block`` (the reference's ``s_max``), its paged pool one
  more block, the write-only sink; the test shows the mapping copies the
  reference's rows exactly and zeroes the port's extra ones.
* A restore copies into the engine's own cache tensors: into an engine
  whose graphs (the CPU stand-in ``ReplayGraph``) are already captured, it
  keeps every tensor and graph, and the trace finishes token for token.
* The hard-kill drill: ``tests/_torch_snapshot_drill_child.py`` serves with
  periodic snapshots and leaves with ``os._exit(17)`` in a child process;
  restored here, pre-crash and post-restore tokens equal an uninterrupted
  run's, and no request is lost.
Tokens, statuses and counters are compared exactly; cache tensors with
``torch.equal``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import errors as ERR
from repro_torch.serving import Engine, FaultPlan, FaultSpec
from repro_torch.serving import engine as ENG

from _torch_port import (no_activation_mesh, one_torch_thread,  # noqa: F401
                         model_pair, port_engine, ref_engine)
from _torch_snapshot_drill_child import (KILL_CODE, build_trace,
                                         drill_engine_config,
                                         drill_model_config)
from test_torch_graph_steps import ReplayGraph

ROOT = pathlib.Path(__file__).resolve().parents[1]
P, NEW = 8, 10
ARRIVALS = (0.0, 0.0, 5.0)
ENGINE = dict(arch="qwen3-moe-30b-a3b", n_slots=2, s_max=32,
              prefill_buckets=(P,))
MODES = {
    # kv_block=4 so an 8-token prompt registers a full prefix block: the
    # snapshot must then carry a non-empty registry in its LRU order
    "dense": dict(),
    "dense-sampled": dict(temperature=0.7),
    "paged": dict(kv_layout="paged", kv_block=4),
    "spec": dict(spec_k=4),
}


@pytest.fixture(scope="module")
def setup():
    rcfg, params, pcfg, model = model_pair("full")
    _, _, ncfg, nmodel = model_pair("merged", seed=1)   # a random draft
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, pcfg.vocab_size, size=P, dtype=np.int32)
               for _ in range(len(ARRIVALS))]
    return dict(rcfg=rcfg, params=params, pcfg=pcfg, model=model,
                draft=(ncfg, nmodel), prompts=prompts)


def _mk(s, mode, **kw):
    return port_engine(s["pcfg"], s["model"],
                       draft=s["draft"] if mode == "spec" else None,
                       **dict(ENGINE, **MODES[mode], **kw))


def _submit(eng, prompts):
    for i, (p, a) in enumerate(zip(prompts, ARRIVALS)):
        eng.submit(p, max_new_tokens=NEW, arrival_time=a, uid=i)


def _advance_once(eng):
    return eng.step_spec() if eng.spec else eng.step_block()


def _tokens(done):
    return {r.uid: (list(r.out_tokens), r.status) for r in done}


def _restore(s, snap, mode, **kw):
    spec = mode == "spec"
    return Engine.restore(snap, cfg=s["pcfg"], params=s["model"],
                          draft_cfg=s["draft"][0] if spec else None,
                          draft_params=s["draft"][1] if spec else None,
                          device="cpu", **kw)


@pytest.fixture(scope="module")
def uninterrupted(setup):
    """mode -> the uninterrupted run's tokens and final counters."""
    out = {}
    for mode in MODES:
        eng = _mk(setup, mode)
        _submit(eng, setup["prompts"])
        out[mode] = (_tokens(eng.run()), dict(eng.counters))
        assert all(st == "ok" for _, st in out[mode][0].values())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_restore_finishes_token_for_token(setup, uninterrupted, mode):
    want, counters = uninterrupted[mode]
    a = _mk(setup, mode)
    _submit(a, setup["prompts"])
    pre = _advance_once(a)             # mid-trace: 2 active + 1 pending
    assert not a.idle and a.n_active == 2 and a.n_pending == 1
    snap = a.snapshot()
    b = _restore(setup, snap, mode)
    assert b.steps == a.steps
    assert b.snapshot()["host"] == snap["host"]
    got_b = _tokens(list(pre) + b.run())
    got_a = _tokens(list(pre) + a.run())      # the engine that kept running
    assert got_b == want and got_a == want
    assert b.counters == counters == a.counters
    if mode == "spec":
        assert counters["tokens_rolled_back"] > 0
    if mode == "paged":
        b._alloc.check_invariants()
        state = b._alloc.state_dict()
        assert not state["owned"]
        pinned = {blk for _, chain in state["registry"] for blk in chain}
        assert b._alloc.free_blocks == b._alloc.nb - len(pinned)
        assert snap["host"]["alloc"]["registry"], "registry not captured"


def test_snapshot_host_part_is_json_safe(setup):
    eng = _mk(setup, "paged")
    _submit(eng, setup["prompts"])
    eng.step_block()
    snap = eng.snapshot()
    assert json.loads(json.dumps(snap["host"])) == snap["host"]
    assert snap["host"]["alloc"]["registry"], "prefix registry not captured"
    assert sorted(snap["arrays"]["cache"]) == ["kp", "pos", "tab", "vp"]
    assert all(t.device.type == "cpu"
               for t in snap["arrays"]["cache"].values())


def test_disk_snapshot_roundtrip_and_digest_guard(setup, uninterrupted,
                                                  tmp_path):
    want, _ = uninterrupted["dense"]
    eng = _mk(setup, "dense")
    _submit(eng, setup["prompts"])
    pre = eng.step_block()
    committed = eng.save_snapshot(tmp_path / "snap")
    assert (committed / "COMMIT").exists()
    meta = json.loads((committed / "meta.json").read_text())
    assert meta["tree_digest"] and meta["step"] == eng.steps
    assert meta["extras"]["engine"]["host"] == eng.snapshot()["host"]

    b = _restore(setup, tmp_path / "snap", "dense")
    assert _tokens(list(pre) + b.run()) == want

    # flip the high byte of the last element of the largest leaf
    leaf = max(committed.glob("leaf_*.npy"), key=lambda p: p.stat().st_size)
    plan = FaultPlan(seed=0, specs=(
        FaultSpec(site="ckpt", kind="corrupt", steps=(0,),
                  byte_offsets=(-1,)),))
    leaf.write_bytes(plan.corrupt(leaf.read_bytes()))
    assert plan.counts() == {"corrupt": 1}
    with pytest.raises(ERR.ArtifactCorruptError, match="digest"):
        _restore(setup, tmp_path / "snap", "dense")
    forensic = _restore(setup, tmp_path / "snap", "dense", verify=False)
    assert isinstance(forensic, Engine)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_reference_snapshot_restores_into_the_port(setup, tmp_path, layout):
    """The reference engine snapshots to disk after its first block and
    finishes; the port restores that directory and finishes with the
    reference's tokens, statuses and counters."""
    # s_max 30 is not a multiple of kv_block 16: the port's dense cache has
    # 32 rows, the reference's 30
    kw = (dict(ENGINE, s_max=30) if layout == "dense"
          else dict(ENGINE, kv_layout="paged", kv_block=4))
    ref = ref_engine(setup["rcfg"], setup["params"], **kw)
    _submit(ref, setup["prompts"])
    pre = ref.step_block()
    ref.save_snapshot(tmp_path / "ref")
    want = _tokens(list(pre) + ref.run())

    eng = Engine.restore(tmp_path / "ref", cfg=setup["pcfg"],
                         params=setup["model"], device="cpu")
    from repro_torch.ckpt import checkpoint as CK
    saved, extras = CK.load(tmp_path / "ref", device="cpu")
    for name, src in saved["cache"].items():
        dst = eng.cache[name]
        if src.shape == dst.shape:
            assert torch.equal(dst, src), name
            continue
        # the rows the port has and the reference does not: past s_max in
        # the dense cache (no slot reaches them), the paged pool's sink
        axis = 2 if layout == "dense" else 1
        n = src.shape[axis]
        assert dst.shape[axis] > n and (layout == "paged"
                                        or n == kw["s_max"])
        assert torch.equal(dst.narrow(axis, 0, n), src), name
        assert not dst.narrow(axis, n, dst.shape[axis] - n).any(), name
    got = _tokens(list(pre) + eng.run())
    assert got == want
    # the snapshot's counters carry the reference guard's two along
    assert eng.counters == ref.counters
    if layout == "paged":
        eng._alloc.check_invariants()
        assert eng._alloc.state_dict() == ref._alloc.state_dict()


def test_restore_into_a_graphed_engine_keeps_its_tensors(setup, uninterrupted,
                                                         monkeypatch):
    """An engine that already served on its graph path (``ReplayGraph``
    stand-in) takes a mid-trace snapshot of another engine in place: every
    cache tensor and static buffer is the same object with the same storage,
    no graph is captured again, and the trace finishes token for token."""
    monkeypatch.setattr(Engine, "_graph_maker",
                        lambda self: (lambda pool: ReplayGraph()))
    want, _ = uninterrupted["paged"]
    a = _mk(setup, "paged")
    _submit(a, setup["prompts"])
    pre = a.step_block()
    snap = a.snapshot()
    b = _mk(setup, "paged")
    _submit(b, setup["prompts"])
    b.run()                                    # every graph captured
    graphs = {k: g for k, gr in b._graphed.items() for k, g in
              gr.graphs.items()}
    tensors = {n: (t, t.data_ptr()) for n, t in
               list(b.cache.items()) + list(b._in.items())}
    b._load_snapshot(snap)
    got = _tokens(list(pre) + b.run())
    assert got == want
    assert {k: g for k, gr in b._graphed.items()
            for k, g in gr.graphs.items()} == graphs
    for n, (t, ptr) in tensors.items():
        now = b.cache.get(n, b._in.get(n))
        assert now is t and now.data_ptr() == ptr, n


def test_copy_cache_refuses_what_does_not_fit(setup):
    eng = _mk(setup, "dense")
    state = ENG._cache_state(eng.cache)
    with pytest.raises(ValueError, match="dtype"):
        ENG._copy_cache(eng.cache, dict(state, k=state["k"].double()), "c")
    with pytest.raises(ValueError, match="does not fit"):
        ENG._copy_cache(eng.cache, dict(state, k=state["k"][:1]), "c")
    with pytest.raises(ValueError, match="snapshot holds"):
        ENG._copy_cache(eng.cache, {"k": state["k"]}, "c")
    snap = eng.snapshot()
    snap["host"]["version"] = 2
    with pytest.raises(ValueError, match="version"):
        eng._load_snapshot(snap)
    paged = _mk(setup, "paged")
    with pytest.raises(ValueError, match="snapshot holds"):
        paged._load_snapshot(eng.snapshot())
    with pytest.raises(ValueError, match="snapshot_every_steps"):
        port_engine(setup["pcfg"], setup["model"],
                    **dict(ENGINE, snapshot_every_steps=-1))


def _drill_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in
                               env.get("PYTHONPATH", "").split(os.pathsep)
                               if p])
    return env


def test_hard_kill_drill_restores_token_for_token(tmp_path):
    """The child dies with ``os._exit`` after a periodic snapshot; restoring
    the directory here and finishing gives, with the requests the child
    finished, the uninterrupted run's tokens, and loses no request."""
    snap_dir = tmp_path / "snaps"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_snapshot_drill_child.py"),
         "--snapshot-dir", str(snap_dir), "--kill-after-steps", "12"],
        capture_output=True, text=True, env=_drill_env(), cwd=str(ROOT),
        timeout=300)
    assert r.returncode == KILL_CODE, r.stdout + r.stderr
    pre_crash = [json.loads(line) for line in r.stdout.splitlines() if line]
    steps = sorted(int(d.name.split("_")[1])
                   for d in snap_dir.glob("step_????????"))
    assert steps and all(b - a >= 4 for a, b in zip(steps, steps[1:])), steps

    cfg = drill_model_config()
    trace = build_trace(cfg.vocab_size)
    full = Engine(drill_engine_config(), cfg=cfg, device="cpu")
    for t in trace:
        full.submit(t["prompt"], t["max_new_tokens"],
                    arrival_time=t["arrival_time"])
    want = {q.uid: [int(t) for t in q.out_tokens] for q in full.run()}

    eng = Engine.restore(snap_dir, cfg=cfg, device="cpu")
    assert 0 < eng.steps <= 12 and eng.steps == steps[-1]
    post = {q.uid: [int(t) for t in q.out_tokens] for q in eng.run()}
    assert post, "the restore resumed nothing"
    for rec in pre_crash:
        assert rec["status"] == "ok"
        assert rec["tokens"] == want[rec["uid"]], rec["uid"]
    for uid, toks in post.items():
        assert toks == want[uid], uid
    assert set(post) | {rec["uid"] for rec in pre_crash} == set(want)
    assert not set(post) & {rec["uid"] for rec in pre_crash}
