"""Shared helpers of the tests/test_torch_*.py differentials: the reduced
fp32 configs, reference parameters crossing into the port, and the staggered
trace both engines serve.

Token parity across frameworks uses ``dtype="float32"`` configs: matmul
reduction orders differ between XLA and PyTorch, and in bf16 a near-tie at
the argmax would flip a token and cascade.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as ref_MD
from repro.models import numerics as ref_numerics
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro_torch import configs, convert
from repro_torch.serving import Engine, EngineConfig, poisson_trace

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(autouse=True, scope="module")
def no_activation_mesh():
    """Every differential test module starts (before its other module-scoped
    fixtures) with the reference's activation mesh cleared, and
    :func:`ref_engine` clears it again after each engine it builds. A reference ``Engine`` built earlier in the same process (by any
    test file) leaves its host mesh installed in a module global, and under
    some jax versions the sharding constraint it arms fails inside plain
    reference functions such as ``layers._sdpa``. None is the module's own
    default, so clearing it changes no result. Test modules import this
    fixture by name to activate it."""
    ref_numerics.set_activation_mesh(None)
    yield
    ref_numerics.set_activation_mesh(None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' tensors are tiny: one intra-op thread runs them as
    fast alone, and with several test processes sharing the cores it keeps
    a module's many small ops from waiting on each other's thread pools.
    The previous setting is restored for the modules that follow. Test
    modules import this fixture by name to activate it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfg_pair(kind: str, dtype: str = "float32", dispatch: str = "gather"):
    """(reference cfg, port cfg) of one reduced model shape under a serving
    dispatch (the configs' own default, capacity dispatch, is not ported).
    kind: 'full' | 'merged' (M=4, split 1) | 'hetero' (live 4 and 3, split 0)."""
    out = []
    for mod in (ref_configs, configs):
        cfg = mod.get(ARCH).reduced().replace(dtype=dtype)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
        if kind == "merged":
            cfg = cfg.compressed(4, split=1)
        elif kind == "hetero":
            cfg = cfg.compressed_per_layer((4, 3), split=0)
        elif kind != "full":
            raise ValueError(kind)
        out.append(cfg)
    return tuple(out)


def ref_tree_numpy(params):
    """The reference's parameter pytree as nested dicts of numpy arrays
    (floating leaves as fp32: exact for bf16 sources)."""
    def leaf(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return np.asarray(a.astype(jnp.float32))
        return np.asarray(a)
    return jax.tree.map(leaf, params)


def fast_jit(fn):
    """``jax.jit(fn)``, each signature compiled with XLA's backend
    optimization level 0: the same HLO, a fifth to a third of the compile
    time on the reduced configs, the outputs within a few fp32 ulps of the
    default build's (2e-6 on their logits). For the reference functions
    the differential tests call once or twice per shape."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), jnp.result_type(a)) for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)
    return call


def ref_params(model):
    """A port model's weights as the reference's parameter tree of jax
    arrays (floating leaves in the model's own types), for a reference
    function to run on: cheaper than the reference's jitted init."""
    def leaf(t):
        a = jnp.asarray(convert.tree_to_numpy(t))
        return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    return jax.tree.map(leaf, convert.reference_tree(model),
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def model_pair(kind: str, dtype: str = "float32", seed: int = 0):
    """(ref cfg, ref params, port cfg, port model on the CPU)."""
    rcfg, pcfg = cfg_pair(kind, dtype)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(seed))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    return rcfg, params, pcfg, model


DENSE_ARCH = "granite-8b"


def dense_pair(arch: str = DENSE_ARCH, dtype: str = "float32", seed: int = 0):
    """(ref cfg, ref params, port cfg, port model on the CPU) of a reduced
    dense-family config: its reference parameters cross over through
    ``convert.from_reference_params`` like the MoE ones."""
    rcfg = ref_configs.get(arch).reduced().replace(dtype=dtype)
    pcfg = configs.get(arch).reduced().replace(dtype=dtype)
    params = ref_MD.init(rcfg, jax.random.PRNGKey(seed))
    model = convert.from_reference_params(ref_tree_numpy(params), pcfg, "cpu")
    return rcfg, params, pcfg, model


# the staggered trace: fewer slots than requests, prompt lengths across two
# buckets, one max_new_tokens=1, one eos_token, and one request that fills
# its slot exactly (prompt + max_new == s_max + 1)
N_SLOTS, S_MAX, BUCKETS = 3, 24, (8, 16)
TRACE = [  # (prompt_len, max_new, eos_from_solo_run)
    (5, 6, False), (14, 4, False), (8, 1, False), (11, 7, True),
    (16, 9, False), (3, 5, False), (9, 16, False),
]


def trace_requests(vocab: int):
    rng = np.random.default_rng(11)
    arrivals = poisson_trace(len(TRACE), rate=0.6, seed=5)
    reqs = []
    for i, (ln, new, _) in enumerate(TRACE):
        reqs.append(dict(prompt=rng.integers(0, vocab, size=ln, dtype=np.int32),
                         max_new_tokens=new, arrival_time=float(arrivals[i])))
    assert any(len(r["prompt"]) + r["max_new_tokens"] == S_MAX + 1
               for r in reqs)
    return reqs


def engine_kwargs(decode_block=8, dispatch="gather", batch_admission=True,
                  arch=ARCH):
    return dict(arch=arch, n_slots=N_SLOTS, s_max=S_MAX,
                prefill_buckets=BUCKETS, decode_block=decode_block,
                dispatch=dispatch, batch_admission=batch_admission)


def run_trace(engine, reqs, eos_for=None):
    """Submit the trace (``eos_for``: {request index: eos token}) and run."""
    for i, r in enumerate(reqs):
        engine.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                      arrival_time=r["arrival_time"],
                      eos_token=(eos_for or {}).get(i))
    done = engine.run()
    return done


def ref_engine(rcfg, params, draft=None, faults=None, **kw):
    """A reference Engine ready to serve on this host: trace_guard off (its
    jit bookkeeping is not under test) and the activation mesh cleared (the
    host mesh's sharding constraints fail under some jax versions; clearing
    it is harmless where they do not). ``draft``: a speculative draft's
    (cfg, params); ``faults``: a reference ``FaultPlan``."""
    eng = RefEngine(RefEngineConfig(trace_guard="off", **kw), cfg=rcfg,
                    params=params, draft_cfg=draft[0] if draft else None,
                    draft_params=draft[1] if draft else None, faults=faults)
    ref_numerics.set_activation_mesh(None)
    return eng


def port_engine(pcfg, model, draft=None, faults=None, **kw):
    """The port's Engine on the CPU (``draft``, ``faults``: as
    :func:`ref_engine`'s, the port's own)."""
    return Engine(EngineConfig(**kw), cfg=pcfg, params=model, device="cpu",
                  draft_cfg=draft[0] if draft else None,
                  draft_params=draft[1] if draft else None, faults=faults)
