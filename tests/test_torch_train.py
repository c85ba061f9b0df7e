"""The port's training path (``repro_torch.launch.steps.make_train_step``,
``launch/train.py``) held against the reference's on the reduced configs.

* The train step against the reference's jitted ``make_train_step`` (no
  mesh), qwen3-moe and granite-8b in fp32 (``grad_dtype="float32"``): loss,
  ce and aux at every step, every gradient leaf, and the parameters and the
  AdamW / adafactor state after 3 steps. The reference's ``bf16_cotangent``
  barrier, an identity in both passes on a bf16 model, fails on an fp32 one
  (``lax.mul`` refuses its bf16 cotangent; ROADMAP C10): for the fp32
  comparisons it is swapped for that identity, inside
  :func:`fp32_reference` only, around freshly jitted reference calls. In
  bf16 the untouched reference's gradients are held at a bf16 tolerance.
* ``grad_dtype`` bf16 rounds every gradient, the fp32 router's included.
* ``microbatches=2``: granite-8b against the reference's accumulation; on
  qwen3-moe the reference's accumulation raises (it adds the float0
  gradients of ``remap`` / ``live``, ROADMAP C9) and the port's equals the
  mean of the reference's gradients of the two halves.
* ``ef_compressed`` over the model's own gradient tree against the
  reference's (stacked leaves, integer leaves counted in the leaf index).
* ``remat`` "full" / "dots" bitwise "none"; ``train=True`` forward logits
  bitwise the serving forward's on the CPU.
* ``launch.train.train`` straight against stopped-and-resumed, bitwise; a
  port training checkpoint resumed by the reference and the reverse.
* The straggler monitor: the reference's own tests on the port's copy, and
  its decisions against the reference's on one scripted sequence.
* A hand-written kernel handed a tensor that requires grad raises; a mesh
  is refused.
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_straggler as ref_straggler_tests
from _torch_port import (no_activation_mesh, one_torch_thread,  # noqa: F401
                         ref_tree_numpy)
from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.distributed import compression as ref_comp
from repro.distributed.straggler import StragglerMonitor as RefMonitor
from repro.launch import steps as ref_steps
from repro.models import layers as ref_layers
from repro.models import model as ref_MD
from repro.models import transformer as ref_transformer
from repro import optim as ref_optim
from repro_torch import configs, convert
from repro_torch import optim as port_optim
from repro_torch.ckpt import checkpoint as port_ckpt
from repro_torch.distributed import compression as port_comp
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.kernels import decode_moe, grouped_mlp
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import swiglu as SW
from repro_torch.launch import steps as ST
from repro_torch.launch import train as LT
from repro_torch.models import model as MD

MOE, DENSE = "qwen3-moe-30b-a3b", "granite-8b"
B, S, STEPS = 4, 16, 3
LR = 1e-3
# fp32 tolerances: the two frameworks' reductions differ in order (gradients
# agree to ~2e-6 of a leaf's max on these configs)
GRAD_RTOL, STATE_RTOL = 2e-5, 2e-4
# AdamW's update is about lr * sign(g) wherever |g| is near eps: a gradient
# of 1e-8 computed in another order moves that parameter by a part of lr
PARAM_ATOL = 0.1 * LR
# bf16 reduced qwen3-moe: a few of 64 rows route to another expert on a
# near-tie of the bf16 residual stream (the serving forward's logits too),
# so bf16 MoE losses agree to this
BF16_MOE_LOSS_RTOL = 1e-2


@contextlib.contextmanager
def fp32_reference():
    """The reference with its ``bf16_cotangent`` barriers as the identity
    they are on a bf16 model, for an fp32 comparison (module docstring)."""
    mods = (ref_layers, ref_transformer, ref_MD)
    saved = [m.bf16_cotangent for m in mods]
    for m in mods:
        m.bf16_cotangent = lambda x: x
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.bf16_cotangent = f


def cfgs(arch, dtype="float32", **kw):
    rcfg = ref_configs.get(arch).reduced().replace(dtype=dtype, **kw)
    pcfg = configs.get(arch).reduced().replace(dtype=dtype, **kw)
    return rcfg, pcfg


def batches(vocab, n=STEPS, seed=0, batch=B):
    data = RefSyntheticLM(vocab, S, batch, seed=seed)
    return [next(data)["tokens"] for _ in range(n)]


def port_model(params, pcfg):
    return convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")


def tok(b):
    return {"tokens": torch.from_numpy(np.asarray(b)).long()}


def close(want, got, rtol=0.0, atol=0.0, what=""):
    """Two trees (numpy vs torch or numpy) leaf for leaf: |a - b| <= atol +
    rtol * max|a| of the leaf; integer leaves equal; None skipped."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            close(want[k], got[k], rtol, atol, f"{what}.{k}")
        return
    if got is None:
        return
    a = np.asarray(want, dtype=np.float64)
    b = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float64))
    assert a.shape == b.shape, what
    if not np.issubdtype(np.asarray(want).dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    err = np.max(np.abs(a - b)) if a.size else 0.0
    assert err <= atol + rtol * np.max(np.abs(a)), (what, err)


_JITTED = {}


def _jitted(key, make):
    """One jitted reference function per key, traced once (fp32 ones inside
    :func:`fp32_reference`) and reused by every test of the module."""
    if key not in _JITTED:
        _JITTED[key] = jax.jit(make())
    return _JITTED[key]


def ref_grads(rcfg, params, b):
    """The reference's loss, metrics and gradients, jitted."""
    def make():
        return jax.value_and_grad(
            lambda p, t: ref_MD.loss(rcfg, p, {"tokens": t}), has_aux=True,
            allow_int=True)
    with fp32_reference() if rcfg.dtype == "float32" else \
            contextlib.nullcontext():
        fn = _jitted(("grads", rcfg), make)
        (l, m), g = fn(params, jnp.asarray(b))
    g = jax.tree.map(lambda x: None if x.dtype == jax.dtypes.float0
                     else np.asarray(x.astype(jnp.float32)), g)
    return float(l), {k: float(v) for k, v in m.items()}, g


def ref_step(rcfg, opt_name, **kw):
    """(the reference's jitted train step, its optimizer) with lr LR."""
    opt = ref_optim.make_optimizer(opt_name, lr=LR)
    key = ("step", rcfg, opt_name, tuple(sorted(kw.items())))
    with fp32_reference() if rcfg.dtype == "float32" else \
            contextlib.nullcontext():
        return _jitted(key, lambda: ref_steps.make_train_step(
            rcfg, opt, **kw)), opt


def ref_train(rcfg, params, opt_name, data, **kw):
    """The reference's jitted step over ``data``: (params, state, [(loss,
    ce, aux)])."""
    fn, opt = ref_step(rcfg, opt_name, **kw)
    with fp32_reference():
        state = opt.init(params)
        hist = []
        for i, b in enumerate(data):
            params, state, l, m = fn(params, state, {"tokens": jnp.asarray(b)},
                                     jnp.asarray(i, jnp.int32))
            hist.append((float(l), float(m["ce"]), float(m["aux"])))
    return ref_tree_numpy(params), ref_tree_numpy(state), hist


def port_train(pcfg, model, opt, data, **kw):
    fn = ST.make_train_step(pcfg, opt, **kw)
    state = opt.init(MD.shape_tree(model))
    hist = []
    for i, b in enumerate(data):
        model, state, l, m = fn(model, state, tok(b), i)
        hist.append((float(l), float(m["ce"]), float(m["aux"])))
    return convert.reference_tree(model), state, hist


# ---------------------------------------------------------------------------
# the step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_loss_and_every_gradient_leaf_match_reference(arch):
    rcfg, pcfg = cfgs(arch)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(0))
    b = batches(rcfg.vocab_size, 1)[0]
    l, m, g = ref_grads(rcfg, params, b)
    pl, pm, pg = ST.loss_and_grads(pcfg, port_model(params, pcfg), tok(b))
    assert float(pl) == pytest.approx(l, rel=1e-6)
    for k in ("ce", "aux"):
        assert float(pm[k]) == pytest.approx(m[k], rel=1e-6, abs=1e-7)
    close(g, pg, rtol=GRAD_RTOL, what="grads")
    assert pg["stack"]["moe" if arch == MOE else "mlp"] is not None


def test_bf16_gradients_match_untouched_reference():
    """A bf16 model, the reference as it is: its barriers are identities.
    The dense family: the MoE's top-k flips on bf16 near-ties between the
    frameworks (``BF16_MOE_LOSS_RTOL``)."""
    rcfg, pcfg = cfgs(DENSE, "bfloat16")
    params = ref_MD.init(rcfg, jax.random.PRNGKey(1))
    b = batches(rcfg.vocab_size, 1, seed=1)[0]
    l, m, g = ref_grads(rcfg, params, b)
    pl, _, pg = ST.loss_and_grads(pcfg, port_model(params, pcfg), tok(b))
    assert float(pl) == pytest.approx(l, rel=2e-3)
    # bf16 products and sums in another order: a few bf16 ulps of a leaf
    close(g, pg, rtol=6e-2, what="bf16 grads")


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_three_steps_match_reference(arch, opt_name):
    rcfg, pcfg = cfgs(arch)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(2))
    data = batches(rcfg.vocab_size, seed=2)
    rp, rs, rh = ref_train(rcfg, params, opt_name, data,
                           grad_dtype="float32")
    pp, ps, ph = port_train(pcfg, port_model(params, pcfg),
                            port_optim.make_optimizer(opt_name, lr=LR), data,
                            grad_dtype="float32")
    np.testing.assert_allclose(np.array(ph), np.array(rh), rtol=1e-5,
                               atol=1e-6)
    close(rp, pp, atol=PARAM_ATOL, what="params")
    # the state crosses to numpy as the reference's tree, leaf for leaf
    close(rs, convert.tree_to_numpy(ps), rtol=STATE_RTOL, atol=1e-12,
          what="state")
    assert ph[-1][0] < ph[0][0] + 0.5          # finite and not diverging


def test_grad_dtype_bf16_rounds_every_gradient_router_included():
    rcfg, pcfg = cfgs(MOE)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(3))
    data = batches(rcfg.vocab_size, 1, seed=3)
    seen = {}

    def hook(g):
        seen["g"] = g
        return g

    model = port_model(params, pcfg)
    _, _, g32 = ST.loss_and_grads(pcfg, model, tok(data[0]))
    pp, _, ph = port_train(pcfg, model, port_optim.adamw(lr=LR), data,
                           grad_transform=hook)
    router = seen["g"]["stack"]["moe"]["router"]
    assert model.stack[0].moe.router.dtype == torch.float32
    assert router.dtype == torch.bfloat16
    assert torch.equal(router, g32["stack"]["moe"]["router"].to(torch.bfloat16))
    assert all(t is None or t.dtype == torch.bfloat16 for t in
               port_optim.optimizers.tree_leaves(seen["g"]))
    rp, _, rh = ref_train(rcfg, params, "adamw", data)
    assert ph[0][0] == pytest.approx(rh[0][0], rel=1e-6)
    # AdamW's first step is lr * sign(g): a bf16 tie rounded the other way
    # moves nothing
    close(rp, pp, atol=PARAM_ATOL, what="params")


def test_microbatched_dense_matches_reference():
    rcfg, pcfg = cfgs(DENSE)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(4))
    data = batches(rcfg.vocab_size, 1, seed=4)
    rp, rs, rh = ref_train(rcfg, params, "adamw", data, microbatches=2,
                           grad_dtype="float32")
    pp, ps, ph = port_train(pcfg, port_model(params, pcfg),
                            port_optim.adamw(lr=LR), data, microbatches=2,
                            grad_dtype="float32")
    np.testing.assert_allclose(np.array(ph), np.array(rh), rtol=1e-5)
    close(rp, pp, atol=PARAM_ATOL, what="params")
    close(rs, ps, rtol=STATE_RTOL, atol=1e-12, what="state")


def test_microbatched_moe_is_the_mean_of_the_halves_c9():
    """The reference's accumulation adds float0 gradients and raises on an
    MoE model (C9); the port's is the mean over the halves."""
    rcfg, pcfg = cfgs(MOE)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(5))
    b = batches(rcfg.vocab_size, 1, seed=5, batch=2 * B)[0]
    with pytest.raises(TypeError, match="float0"):
        ref_train(rcfg, params, "adamw", [b], microbatches=2)
    halves = [ref_grads(rcfg, params, b[i * B:(i + 1) * B]) for i in (0, 1)]
    pl, pm, pg = ST.loss_and_grads(pcfg, port_model(params, pcfg), tok(b),
                                   microbatches=2)
    assert float(pl) == pytest.approx((halves[0][0] + halves[1][0]) / 2,
                                      rel=1e-6)
    assert float(pm["aux"]) == pytest.approx(
        (halves[0][1]["aux"] + halves[1][1]["aux"]) / 2, rel=1e-6)
    mean = jax.tree.map(lambda a, c: None if a is None else (a + c) / 2,
                        halves[0][2], halves[1][2],
                        is_leaf=lambda x: x is None)
    close(mean, pg, rtol=GRAD_RTOL, what="mean grads")


def test_ef_compressed_over_the_model_tree_matches_reference():
    """The model's gradient tree (stacked leaves, integer leaves; random
    values) through both packages' ef_compressed(adamw), each of 2 steps
    from the same state: the noise's leaf index and the stack-wide scale
    are the reference's, so the updates agree and the residuals to an fp32
    ulp."""
    rcfg, _ = cfgs(MOE)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(6))
    ropt = ref_comp.ef_compressed(ref_optim.adamw(lr=LR), seed=9)
    popt = port_comp.ef_compressed(port_optim.adamw(lr=LR), seed=9)
    rstate = ropt.init(params)
    tparams = convert.tree_to_torch(ref_tree_numpy(params))
    pstate = popt.init(tparams)
    upd = jax.jit(ropt.update)
    rng = np.random.default_rng(6)
    for i in range(2):
        g = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape).astype(np.float32)
                       if jnp.issubdtype(x.dtype, jnp.floating) else None),
            params)
        rg = jax.tree.map(
            lambda x, p: (jnp.asarray(x) if x is not None else
                          np.zeros(p.shape, jax.dtypes.float0)),
            g, params, is_leaf=lambda x: x is None)
        ru, rstate = upd(rg, rstate, params, jnp.asarray(i, jnp.int32))
        pu, pstate = popt.update(_torch_grads(g), pstate, tparams, i)
        close(ref_tree_numpy(ru), pu, atol=1e-9, what=f"updates {i}")
        close(ref_tree_numpy(rstate), pstate, atol=1e-6, what=f"state {i}")
        # the next step from the reference's state: its jitted residual
        # ``corrected - q * scale`` may differ from the two roundings by an
        # ulp, and a later step's int8 rounding with it
        pstate = convert.tree_to_torch(ref_tree_numpy(rstate))


def _torch_grads(g):
    if isinstance(g, dict):
        return {k: _torch_grads(v) for k, v in g.items()}
    return None if g is None else torch.from_numpy(np.array(g))


# ---------------------------------------------------------------------------
# the port's own: remat, the training forward, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_remat_is_bitwise_no_remat(arch, remat):
    _, pcfg = cfgs(arch, "bfloat16")
    b = tok(batches(pcfg.vocab_size, 1, seed=7)[0])
    want = ST.loss_and_grads(pcfg, MD.init(pcfg, "cpu", seed=7), b)
    rcfg = pcfg.replace(remat=remat)
    got = ST.loss_and_grads(rcfg, MD.init(rcfg, "cpu", seed=7), b)
    assert torch.equal(want[0], got[0])
    for (name, a), (_, c) in zip(_leaves(want[2]), _leaves(got[2])):
        assert torch.equal(a, c), name


def _leaves(tree, pre=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(_leaves(tree[k], f"{pre}{k}."))
        elif tree[k] is not None:
            out.append((pre + k, tree[k]))
    return out


@pytest.mark.parametrize("arch", [MOE, DENSE])
def test_training_forward_is_the_serving_forward_on_the_cpu(arch):
    _, pcfg = cfgs(arch, "bfloat16", remat="full")
    model = MD.trainable(MD.init(pcfg, "cpu", seed=8))
    b = tok(batches(pcfg.vocab_size, 1, seed=8)[0])
    served, aux_s, _ = MD.forward(pcfg, model, b)
    trained, aux_t, _ = MD.forward(pcfg, model, b, train=True)
    assert trained.requires_grad and not served.requires_grad
    assert torch.equal(served, trained.detach())
    assert torch.equal(aux_s, aux_t.detach())


def _tc(tmp_path, name, steps, **kw):
    return LT.TrainConfig(device="cpu", steps=steps, global_batch=B,
                          seq_len=S, lr=LR, log_every=100,
                          ckpt_dir=str(tmp_path / name), ckpt_every=2, **kw)


@pytest.mark.parametrize("compression", [False, True])
def test_trainer_resumed_equals_straight_bitwise(tmp_path, compression):
    straight = LT.train(_tc(tmp_path, "a", 4, grad_compression=compression))
    first = LT.train(_tc(tmp_path, "b", 2, grad_compression=compression))
    rest = LT.train(_tc(tmp_path, "b", 4, grad_compression=compression))
    assert first["losses"] + rest["losses"] == straight["losses"]
    a = convert.reference_tree(straight["params"])
    c = convert.reference_tree(rest["params"])
    for (name, x), (_, y) in zip(_leaves(a), _leaves(c)):
        assert torch.equal(x, y), name
    assert not any(p.requires_grad for p in rest["params"].parameters())
    sa = ref_ckpt.load(tmp_path / "a")[0][1]
    sb = ref_ckpt.load(tmp_path / "b")[0][1]
    jax.tree.map(np.testing.assert_array_equal, sa, sb)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    """A port trainer's checkpoint (bf16 reduced qwen3-moe, AdamW): the
    reference's CheckpointManager restores it bitwise, and its step from it
    agrees with the port's resumed step."""
    LT.train(_tc(tmp_path, "p", 2))
    (params, state), extras = ref_ckpt.CheckpointManager(
        tmp_path / "p").restore()
    port_state, port_extras = port_ckpt.load(tmp_path / "p", device="cpu")
    assert extras == port_extras
    assert ref_ckpt.tree_digest((params, state)) == port_ckpt.tree_digest(
        port_state)
    rcfg = ref_configs.get(MOE).reduced()
    data = RefSyntheticLM(rcfg.vocab_size, S, B, seed=0)
    data._state.step = 2
    b = next(data)["tokens"]
    fn, _ = ref_step(rcfg, "adamw")
    rp, _, rl, _ = fn(params, state, {"tokens": jnp.asarray(b)},
                      jnp.asarray(2, jnp.int32))
    out = LT.train(_tc(tmp_path, "p", 3))
    assert out["losses"][0] == pytest.approx(float(rl),
                                             rel=BF16_MOE_LOSS_RTOL)
    close(ref_tree_numpy(rp), convert.reference_tree(out["params"]),
          atol=2e-2, what="params after the resumed step")


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's training state (bf16 reduced qwen3-moe, one AdamW
    step, the data cursor in the extras) written by its CheckpointManager:
    the port's trainer resumes it and its step agrees with the reference's
    next step."""
    rcfg = ref_configs.get(MOE).reduced()
    fn, opt = ref_step(rcfg, "adamw")
    params = ref_MD.init(rcfg, jax.random.PRNGKey(0))
    state = opt.init(params)
    data = RefSyntheticLM(rcfg.vocab_size, S, B, seed=0)
    for i in range(2):
        b = next(data)["tokens"]
        params, state, l, _ = fn(params, state, {"tokens": jnp.asarray(b)},
                                 jnp.asarray(i, jnp.int32))
        if i == 0:
            ref_ckpt.CheckpointManager(tmp_path / "r").save(
                1, (params, state),
                {"data_state": data.state().to_json()})
    out = LT.train(_tc(tmp_path, "r", 2))
    assert out["losses"][0] == pytest.approx(float(l),
                                             rel=BF16_MOE_LOSS_RTOL)
    close(ref_tree_numpy(params), convert.reference_tree(out["params"]),
          atol=2e-2, what="params after the resumed step")


def test_mesh_shape_is_refused():
    with pytest.raises(NotImplementedError, match="A15"):
        LT.build(LT.TrainConfig(device="cpu", mesh_shape="2,1"))


def test_cli_trains_on_the_cpu(capsys):
    LT.main(["--device", "cpu", "--steps", "2", "--global-batch", "2",
             "--seq-len", "8", "--log-every", "1", "--arch", DENSE])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[train] step=0 loss=")
    assert np.isfinite(json.loads(lines[-1])["final_loss"])


# ---------------------------------------------------------------------------
# the straggler monitor
# ---------------------------------------------------------------------------

REF_STRAGGLER_TESTS = [n for n in dir(ref_straggler_tests)
                       if n.startswith("test_")]


@pytest.mark.parametrize("name", REF_STRAGGLER_TESTS)
def test_reference_straggler_case_on_the_port(name, monkeypatch):
    monkeypatch.setattr(ref_straggler_tests, "StragglerMonitor",
                        StragglerMonitor)
    getattr(ref_straggler_tests, name)()


def test_straggler_decisions_match_reference():
    rng = np.random.default_rng(0)
    durations = np.concatenate([rng.uniform(0.09, 0.11, 40),
                                rng.uniform(0.3, 0.5, 7),
                                rng.uniform(0.09, 0.11, 10),
                                [0.05, 1.0, 0.1, 0.25, 0.21]])
    want = RefMonitor(window=16, threshold=2.0, patience=5, warmup=3)
    got = StragglerMonitor(window=16, threshold=2.0, patience=5, warmup=3)
    fired = 0
    for d in durations:
        a, c = want.observe(float(d)), got.observe(float(d))
        assert dataclasses.asdict(a) == dataclasses.asdict(c)
        fired += a.should_restart
    assert fired > 0


# ---------------------------------------------------------------------------
# the kernels have no backward
# ---------------------------------------------------------------------------

def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape, grad=False):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    from repro_torch.core.quant import quantize_expert_tables
    x, wg, wu, wd = r(4, 16, grad=True), r(3, 16, 8), r(3, 16, 8), r(3, 8, 16)
    idx = torch.zeros((4, 2), dtype=torch.int32)
    w = torch.full((4, 2), 0.5)
    gs = torch.tensor([4, 0, 0], dtype=torch.int32)
    qt = quantize_expert_tables(wg, wu, wd)
    q = r(2, 4, 8, grad=True)
    kp = r(3, 4, 2, 8)
    tab = torch.zeros((2, 1), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    kq = torch.zeros((3, 4, 2, 8), dtype=torch.int8)
    ks = torch.ones((3, 4, 2))
    return {
        "swiglu_mlp": lambda: SW.swiglu_mlp(x, wg[0], wu[0], wd[0]),
        "flash_attention": lambda: FA.attend(r(1, 2, 4, 8, grad=True),
                                             r(1, 2, 4, 8), r(1, 2, 4, 8),
                                             True),
        "gather_swiglu": lambda: decode_moe.gather_swiglu(x, wg, wu, wd, idx,
                                                          w),
        "gather_swiglu_q": lambda: decode_moe.gather_swiglu_q(x, qt, idx, w),
        "grouped_swiglu": lambda: grouped_mlp.grouped_swiglu(x, wg, wu, wd,
                                                             gs),
        "grouped_swiglu_q": lambda: grouped_mlp.grouped_swiglu_q(x, qt, gs),
        "paged_attention": lambda: PA.paged_attention(q, kp, kp, tab, lens),
        "paged_attention_q": lambda: PA.paged_attention_q(q, kq, kq, ks, ks,
                                                          tab, lens),
    }


@pytest.mark.parametrize("kernel", sorted(_kernel_calls()))
def test_kernel_handed_a_tensor_that_requires_grad_raises(kernel):
    call = _kernel_calls()[kernel]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    # outside autograd the same call reaches the device check (a CPU tensor
    # is not the kernel's): the guard is about gradients only
    with torch.no_grad(), pytest.raises(ValueError, match="needs CUDA"):
        call()
