"""Training the vlm, ssm, hybrid and audio families
(``launch/steps.py :: loss_and_grads / make_train_step``,
``launch/train.py``) held against the reference's, on the CPU.

The reduced configs of mamba2-370m, zamba2-2.7b (at 4 layers: two
segments of the shared block), whisper-base (with frames) and
phi-3-vision-4.2b (with patches), batch 2 of 40 tokens (two SSD chunks of
32, the second padded):

* fp32: the loss, its metrics and every gradient leaf against the
  reference's jitted ``value_and_grad`` of its loss, within ``GRAD_RTOL`` of
  the leaf's largest value; 3 AdamW steps against its ``make_train_step``,
  each from the reference's parameters and state, the parameters and the
  optimizer state after each held as ``test_torch_train.py`` holds the dense
  and moe families; the same 3 steps run straight on each side, held so
  that a gap compounding across steps shows (the parameters AdamW's eps
  decides set apart and printed). The reference's ``bf16_cotangent``
  barriers are swapped for the identity they are on a bf16 model
  (``test_torch_train.fp32_reference``, ROADMAP C10);
* mamba2 in bf16 against the untouched reference, at the bf16 tolerances
  stated below;
* ``microbatches=2`` on the vlm with patches against the reference's
  accumulation;
* the port alone: remat "full" and "dots" bitwise "none"; the training
  forward's logits bitwise the serving forward's; finite gradients through
  the SSD scan at a sequence a multiple of the chunk and not; the trainer
  on the pipeline's token batches (ssm, hybrid, vlm) bitwise the train step
  driven by hand;
* ROADMAP C13: the reference's loss fails on the token-only batch its
  trainer feeds an audio model, and the port's trainer refuses one.

The reference functions are compiled once per module
(``_torch_port.fast_jit``), on the port's weights handed over as its tree:
one train step per config, which also hands back its gradients, serves the
gradient and the AdamW tests.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_activation_mesh, one_torch_thread  # noqa: F401
from _torch_port import fast_jit, ref_params, ref_tree_numpy
from repro import configs as ref_configs
from repro import optim as ref_optim
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import steps as ref_steps
from repro.models import model as ref_MD
from repro_torch import configs, convert
from repro_torch import optim as port_optim
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps as ST
from repro_torch.launch import train as LT
from repro_torch.models import model as MD
from test_torch_train import (GRAD_RTOL, LR, PARAM_ATOL, STATE_RTOL, close,
                              fp32_reference)

FAMILIES = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
            "audio": "whisper-base", "vlm": "phi-3-vision-4.2b"}
B, S, STEPS = 2, 40, 3
# AdamW's defaults (``optim.adamw``, both sides)
B1, B2, EPS = 0.9, 0.95, 1e-8
# below this bias-corrected sqrt(v), an fp32 difference of a gradient moves
# AdamW's normalised update m / (sqrt(v) + eps) by a part of one
NEAR_EPS = 10 * EPS
# mamba2 in bf16: the losses to a bf16 rounding of the logits' sum; each
# gradient leaf to a few bf16 ulps of its largest value (bf16 products and
# sums in another order through the projections and the conv)
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 2e-3, 6e-2


def cfgs(family, dtype="float32"):
    """(reference cfg, port cfg): the family's reduced config in ``dtype``,
    zamba2 at 4 layers."""
    arch = FAMILIES[family]
    kw = dict(dtype=dtype)
    if family == "hybrid":
        kw["n_layers"] = 4
    return (ref_configs.get(arch).reduced().replace(**kw),
            configs.get(arch).reduced().replace(**kw))


def extra_inputs(cfg, rng, batch=B):
    """The family's seeded ``patches`` / ``frames`` (numpy fp32)."""
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (batch, cfg.vlm_num_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)}
    return {}


def batches(cfg, n=STEPS, seed=0, batch=B, seq=S):
    """``n`` numpy batches: SyntheticLM tokens and the family's inputs."""
    data = RefSyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    rng = np.random.default_rng(seed)
    return [dict(tokens=next(data)["tokens"], **extra_inputs(cfg, rng, batch))
            for _ in range(n)]


def to_port(b, dtype=torch.float32):
    """A numpy batch as the port's: tokens int64, the rest in ``dtype``."""
    return {k: (torch.from_numpy(np.asarray(v)).long() if k == "tokens"
                else torch.from_numpy(np.asarray(v)).to(dtype))
            for k, v in b.items()}


def to_ref(b, dtype=jnp.float32):
    return {k: (jnp.asarray(v) if k == "tokens" else jnp.asarray(v, dtype))
            for k, v in b.items()}


_COMPILED = {}


def compiled(key, make):
    """One reference function per key, built (inside ``fp32_reference`` for
    fp32 configs) and compiled once for the module."""
    if key not in _COMPILED:
        _COMPILED[key] = fast_jit(make())
    return _COMPILED[key]


def barrier(rcfg):
    return fp32_reference() if rcfg.dtype == "float32" else \
        contextlib.nullcontext()


def ref_step(rcfg):
    """(optimizer, step): the reference's ``make_train_step`` (AdamW at LR,
    fp32 gradients), compiled once per config for the gradient and the
    AdamW tests alike. ``step(params, state, batch, i)`` returns the step's
    ``(params, state, loss, metrics)`` and the gradients it handed the
    optimizer, read through its ``grad_transform`` hook: at one microbatch
    and fp32 these are its jitted ``value_and_grad``'s, unclipped."""
    opt = ref_optim.adamw(lr=LR)

    def make():
        seen = {}

        def keep(grads):
            seen["grads"] = grads
            return grads
        step = ref_steps.make_train_step(rcfg, opt, grad_dtype="float32",
                                         grad_transform=keep)
        return lambda *a: (step(*a), seen["grads"])
    with barrier(rcfg):
        return opt, compiled(("step", rcfg), make)


def ref_grads(rcfg, params, b):
    """The reference's loss, metrics and gradients (numpy fp32, None at
    integer leaves)."""
    opt, step = ref_step(rcfg)
    with barrier(rcfg):
        (_, _, l, m), g = step(params, opt.init(params), b,
                               jnp.asarray(0, jnp.int32))
    g = jax.tree.map(lambda x: None if x.dtype == jax.dtypes.float0
                     else np.asarray(x.astype(jnp.float32)), g)
    return float(l), {k: float(v) for k, v in m.items()}, g


def ref_train(rcfg, params, data, **kw):
    """The reference's train step (AdamW at LR, fp32 gradients) over
    ``data``: (params, state, [(loss, ce, aux)])."""
    opt = ref_optim.adamw(lr=LR)

    def make():
        return ref_steps.make_train_step(rcfg, opt, grad_dtype="float32", **kw)
    with barrier(rcfg):
        fn = compiled(("step", rcfg, tuple(sorted(kw.items()))), make)
        state = opt.init(params)
        hist = []
        for i, b in enumerate(data):
            params, state, l, m = fn(params, state, to_ref(b),
                                     jnp.asarray(i, jnp.int32))
            hist.append((float(l), float(m["ce"]), float(m["aux"])))
    return ref_tree_numpy(params), ref_tree_numpy(state), hist


def port_train(pcfg, model, data, **kw):
    fn = ST.make_train_step(pcfg, port_optim.adamw(lr=LR),
                            grad_dtype="float32", **kw)
    state = port_optim.adamw(lr=LR).init(MD.shape_tree(model))
    hist = []
    for i, b in enumerate(data):
        model, state, l, m = fn(model, state, to_port(b), i)
        hist.append((float(l), float(m["ce"]), float(m["aux"])))
    return convert.reference_tree(model), state, hist


def leaves(tree, pre=""):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.extend(leaves(tree[k], f"{pre}{k}."))
        elif tree[k] is not None:
            out.append((pre + k, tree[k]))
    return out


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference(family):
    rcfg, pcfg = cfgs(family)
    model = MD.init(pcfg, "cpu", seed=1)
    b = batches(pcfg, 1, seed=1)[0]
    l, m, g = ref_grads(rcfg, ref_params(model), to_ref(b))
    pl, pm, pg = ST.loss_and_grads(pcfg, model, to_port(b))
    assert float(pl) == pytest.approx(l, rel=1e-6)
    for k in ("ce", "aux"):
        assert float(pm[k]) == pytest.approx(m[k], rel=1e-6, abs=1e-7)
    close(g, pg, rtol=GRAD_RTOL, what="grads")
    assert all(bool(torch.isfinite(t).all()) for _, t in leaves(pg))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_adamw_steps_match_reference(family):
    """Each of 3 AdamW steps (step counts 0, 1, 2) from the reference's
    parameters and state after the step before: the loss and metrics, every
    parameter and every state leaf after it. Started from the reference's
    own, so that a parameter whose clipped gradient sits near AdamW's eps
    (where fp32 noise between the frameworks decides a part of lr) does not
    carry its gap into the next step's forward."""
    rcfg, pcfg = cfgs(family)
    model = MD.init(pcfg, "cpu", seed=2)
    params = ref_params(model)
    opt, fn = ref_step(rcfg)
    state = opt.init(params)
    step = ST.make_train_step(pcfg, port_optim.adamw(lr=LR),
                              grad_dtype="float32")
    losses = []
    for i, b in enumerate(batches(pcfg, seed=2)):
        model = convert.from_reference_params(ref_tree_numpy(params), pcfg,
                                              "cpu")
        pstate = convert.tree_to_torch(ref_tree_numpy(state))
        model, pstate, pl, pm = step(model, pstate, to_port(b), i)
        with barrier(rcfg):
            (params, state, l, m), _ = fn(params, state, to_ref(b),
                                          jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(
            [float(pl), float(pm["ce"]), float(pm["aux"])],
            [float(l), float(m["ce"]), float(m["aux"])], rtol=1e-5, atol=1e-6)
        close(ref_tree_numpy(params), convert.reference_tree(model),
              atol=PARAM_ATOL, what=f"params after step {i}")
        close(ref_tree_numpy(state), convert.tree_to_numpy(pstate),
              rtol=STATE_RTOL, atol=1e-12, what=f"state after step {i}")
        losses.append(float(pl))
    assert losses[-1] < losses[0] + 0.5        # finite and not diverging


def adamw_readings(states, name, idx):
    """An element's clipped gradient and the bias-corrected ``sqrt(v)``
    AdamW divided it by, at each step, read back from the optimizer's state
    after each step (numpy trees): ``g_t = (m_t - B1 m_{t-1}) / (1 - B1)``."""
    g, root, m_last = [], [], 0.0
    for t, st in enumerate(states):
        leaf = dict(leaves(st))
        m, v = float(leaf[name + ".m"][idx]), float(leaf[name + ".v"][idx])
        g.append((m - B1 * m_last) / (1 - B1))
        root.append((v / (1 - B2 ** (t + 1))) ** 0.5)
        m_last = m
    return g, root


def sqrt_vhat_floor(states):
    """{parameter leaf: the least bias-corrected ``sqrt(v)`` of each element
    over ``states`` (one optimizer state per step)}."""
    out = {}
    for t, st in enumerate(states):
        for name, v in leaves(st):
            if name.endswith(".v"):
                x = np.sqrt(np.asarray(v, np.float64) / (1 - B2 ** (t + 1)))
                key = name[:-len(".v")]
                out[key] = np.minimum(out[key], x) if key in out else x
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_three_adamw_steps_run_straight_match_reference(family):
    """The same 3 AdamW steps run straight on each side from the same
    weights, so that a gap that compounds from step to step shows: every
    loss as in the per-step test; every parameter within PARAM_ATOL of the
    reference's but those whose ``sqrt(v)`` fell below NEAR_EPS at some step
    on either side, where AdamW's ``m / (sqrt(v) + eps)`` turns an fp32
    difference of the gradient into a part of lr (those within the most
    two AdamW runs can part, 2 lr a step; each one past PARAM_ATOL printed
    with its gradient and ``sqrt(v)`` on both sides, beside eps); every
    optimizer state leaf's median gap within STATE_RTOL of its largest
    value."""
    rcfg, pcfg = cfgs(family)
    model = MD.init(pcfg, "cpu", seed=2)
    # a copy: the port's step writes its model in place
    params = jax.tree.map(lambda x: jnp.array(x, copy=True),
                          ref_params(model))
    opt, fn = ref_step(rcfg)
    state = opt.init(params)
    step = ST.make_train_step(pcfg, port_optim.adamw(lr=LR),
                              grad_dtype="float32")
    pstate = port_optim.adamw(lr=LR).init(MD.shape_tree(model))
    data = batches(pcfg, seed=2)
    want, got, want_states, got_states = [], [], [], []
    for i, b in enumerate(data):
        with barrier(rcfg):
            (params, state, l, m), _ = fn(params, state, to_ref(b),
                                          jnp.asarray(i, jnp.int32))
        model, pstate, pl, pm = step(model, pstate, to_port(b), i)
        want.append([float(l), float(m["ce"]), float(m["aux"])])
        got.append([float(pl), float(pm["ce"]), float(pm["aux"])])
        want_states.append(ref_tree_numpy(state))
        got_states.append(jax.tree.map(np.copy,
                                       convert.tree_to_numpy(pstate)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    floor_w, floor_g = sqrt_vhat_floor(want_states), \
        sqrt_vhat_floor(got_states)
    port = dict(leaves(convert.reference_tree(model)))
    for name, a in leaves(ref_tree_numpy(params)):
        gap = np.abs(np.asarray(a, np.float64)
                     - port[name].detach().double().numpy())
        near = np.minimum(floor_w[name], floor_g[name]) < NEAR_EPS
        assert gap[~near].max(initial=0.0) <= PARAM_ATOL, name
        assert gap[near].max(initial=0.0) <= 2 * LR * STEPS, name
        for idx in map(tuple, np.argwhere(gap > PARAM_ATOL)):
            (gw, rw), (gg, rg) = (adamw_readings(st, name, idx) for st in
                                  (want_states, got_states))
            print(f"{pcfg.name} {name}{list(idx)}: gap {gap[idx]:.4g} after "
                  f"{STEPS} steps; clipped g reference {gw} port {gg}; "
                  f"sqrt(v_hat) reference {rw} port {rg}; eps {EPS}")
    port_state = dict(leaves(got_states[-1]))
    for name, a in leaves(want_states[-1]):
        a = np.asarray(a, np.float64)
        gap = np.abs(a - port_state[name])
        assert np.median(gap) <= STATE_RTOL * np.abs(a).max(), name


def test_bf16_ssm_gradients_match_untouched_reference():
    """mamba2 in bf16, the reference as it is (its barriers are identities
    on a bf16 model): the projections in bf16, the SSD scan in fp32, the
    blocks' dt_bias, A_log and D fp32 leaves."""
    rcfg, pcfg = cfgs("ssm", "bfloat16")
    model = MD.init(pcfg, "cpu", seed=3)
    b = batches(pcfg, 1, seed=3)[0]
    l, _, g = ref_grads(rcfg, ref_params(model), to_ref(b))
    pl, _, pg = ST.loss_and_grads(pcfg, model, to_port(b))
    assert float(pl) == pytest.approx(l, rel=BF16_LOSS_RTOL)
    close(g, pg, rtol=BF16_GRAD_RTOL, what="bf16 grads")
    assert pg["ssm"]["A_log"].dtype == torch.float32
    assert pg["ssm"]["in_proj"].dtype == torch.bfloat16


def test_microbatched_vlm_with_patches_matches_reference():
    """``microbatches=2`` splits every batch key, the patches too: one
    AdamW step from a batch of 2 * B rows."""
    rcfg, pcfg = cfgs("vlm")
    model = MD.init(pcfg, "cpu", seed=4)
    data = batches(pcfg, 1, seed=4, batch=2 * B)
    rp, rs, rh = ref_train(rcfg, ref_params(model), data, microbatches=2)
    pp, ps, ph = port_train(pcfg, model, data, microbatches=2)
    np.testing.assert_allclose(np.array(ph), np.array(rh), rtol=1e-5,
                               atol=1e-6)
    close(rp, pp, atol=PARAM_ATOL, what="params")
    close(rs, convert.tree_to_numpy(ps), rtol=STATE_RTOL, atol=1e-12,
          what="state")


def test_c13_reference_fails_on_a_token_only_audio_batch():
    """ROADMAP C13, asserted so that this test notes when the reference
    changes: its trainer feeds the pipeline's token batches, on which an
    audio model's loss fails (no frames); the port's trainer refuses the
    family before it allocates anything."""
    rcfg, pcfg = cfgs("audio", "bfloat16")
    params = jax.eval_shape(lambda: ref_MD.init(rcfg, jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    with pytest.raises(KeyError, match="frames"):
        jax.eval_shape(lambda p, t: ref_MD.loss(rcfg, p, {"tokens": t}),
                       params, toks)
    with pytest.raises(ValueError, match="frames"):
        LT.build(LT.TrainConfig(arch=FAMILIES["audio"], device="cpu"))


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bitwise_no_remat(family, remat):
    _, pcfg = cfgs(family, "bfloat16")
    b = to_port(batches(pcfg, 1, seed=5)[0], pcfg.param_dtype)
    want = ST.loss_and_grads(pcfg.replace(remat="none"),
                             MD.init(pcfg, "cpu", seed=5), b)
    rcfg = pcfg.replace(remat=remat)
    got = ST.loss_and_grads(rcfg, MD.init(rcfg, "cpu", seed=5), b)
    assert torch.equal(want[0], got[0])
    for (name, a), (_, c) in zip(leaves(want[2]), leaves(got[2])):
        assert torch.equal(a, c), name


@pytest.mark.parametrize("family", list(FAMILIES))
def test_training_forward_is_the_serving_forward_on_the_cpu(family):
    _, pcfg = cfgs(family, "bfloat16")
    model = MD.trainable(MD.init(pcfg.replace(remat="full"), "cpu", seed=6))
    b = to_port(batches(pcfg, 1, seed=6)[0], pcfg.param_dtype)
    served, aux_s, _ = MD.forward(pcfg, model, b)
    trained, aux_t, _ = MD.forward(pcfg.replace(remat="full"), model, b,
                                   train=True)
    assert trained.requires_grad and not served.requires_grad
    assert torch.equal(served, trained.detach())
    assert torch.equal(aux_s, aux_t.detach())


@pytest.mark.parametrize("seq", [32, 64, 33, 17])
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_ssd_gradients_finite_at_and_off_the_chunk(family, seq):
    """The masked entries of ``exp(_segsum)`` (``-inf`` above the diagonal)
    give zero, not NaN, in the backward: at a sequence a whole number of
    chunks (32) and padded to one."""
    _, pcfg = cfgs(family)
    assert pcfg.ssm.chunk_size == 32
    model = MD.init(pcfg, "cpu", seed=7)
    b = to_port(batches(pcfg, 1, seed=7, seq=seq)[0])
    total, _, g = ST.loss_and_grads(pcfg, model, b)
    assert bool(torch.isfinite(total))
    named = dict(leaves(g))
    assert all(bool(torch.isfinite(t).all()) for t in named.values())
    prefix = "ssm." if family == "ssm" else "hybrid.mamba."
    assert float(named[prefix + "A_log"].abs().max()) > 0
    assert float(named[prefix + "in_proj"].abs().max()) > 0


@pytest.mark.parametrize("family", ["ssm", "hybrid", "vlm"])
def test_trainer_on_the_pipeline_is_the_step_driven_by_hand(family):
    """``launch.train.train`` on the CPU for a few steps of the pipeline's
    token batches (a vlm on its text alone), bitwise the train step driven
    by hand on the same batches from the same weights."""
    arch = FAMILIES[family]
    tc = LT.TrainConfig(arch=arch, device="cpu", steps=3, global_batch=B,
                        seq_len=S, lr=LR, log_every=100)
    out = LT.train(tc)
    cfg, model, state, step = LT.build(tc)
    data = make_pipeline(cfg, S, B, seed=tc.seed)
    losses = []
    for i in range(tc.steps):
        model, state, loss, _ = step(model, state,
                                     LT.to_device(next(data), "cpu"), i)
        losses.append(float(loss))
    assert out["losses"] == losses
    assert all(np.isfinite(losses)) and cfg.family == family
    for (name, a), (_, c) in zip(leaves(convert.reference_tree(model)),
                                 leaves(convert.reference_tree(
                                     out["params"]))):
        assert torch.equal(a, c), name
