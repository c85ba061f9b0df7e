"""The port stands alone: it imports neither ``jax`` nor the reference
package, calls no library attention and no compiler, and its entry points
refuse to run on the CPU unless asked.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_the_reference():
    mods = list(_modules())
    assert len(mods) > 25 and "repro_torch.serving.engine" in mods
    assert {"repro_torch.core.quant", "repro_torch.serving.paging",
            "repro_torch.kernels.paged_attention",
            "repro_torch.ckpt.checkpoint", "repro_torch.ckpt.treedef"} \
        <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout


#: the functions of chip_smoke.py that time a library call as the kernels
#: line's ``library_ms`` yardstick, never called by the port: one attention
#: call, and the cuBLAS composition (``torch.mm`` x2, silu * mul,
#: ``torch.mm``) that the model's MLP ran before the ``swiglu_mlp`` kernel
YARDSTICKS = ("library_attention_ms", "previous_mlp_apply")


def _nodes(tree):
    """Every node, except the bodies of chip_smoke.py's yardstick
    functions."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in YARDSTICKS:
            node.body = []
    return ast.walk(tree)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_forbidden_import_or_call(path):
    text = path.read_text()
    tree = ast.parse(text)
    if path.name != "chip_smoke.py":
        assert not any(y in text for y in YARDSTICKS), path
    else:
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)}
        assert set(YARDSTICKS) <= defined
    for node in _nodes(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), \
                f"{path}: imports {name}"
        if isinstance(node, ast.Attribute):
            assert node.attr != "scaled_dot_product_attention", path
            assert not (node.attr == "compile"
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "torch"), f"{path}: torch.compile"
        if isinstance(node, ast.Name):
            assert node.id != "scaled_dot_product_attention", path


def test_every_tpu_kernel_has_a_wrapper_and_a_source():
    """The eight TPU kernels of the reference, each with its hand-written
    counterpart: a wrapper with a launch counter in ``ops.KERNELS`` and a
    source in the build."""
    from repro_torch.kernels import _build, ops
    want = ("gather_swiglu", "grouped_swiglu", "gather_swiglu_q",
            "grouped_swiglu_q", "paged_attention", "paged_attention_q",
            "flash_attention", "swiglu_mlp")
    assert tuple(ops.KERNELS) == want
    assert set(_build.KERNEL_SOURCES) == set(want)
    assert all(k.name == n and k.LAUNCHES == 0
               for n, k in ops.KERNELS.items())


def test_chip_smoke_fails_without_a_gpu():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=ENV, capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "CUDA" in out.stderr


def test_engine_default_device_is_cuda_and_raises_without_one():
    import torch
    from repro_torch.serving import Engine, EngineConfig
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig())
    eng = Engine(EngineConfig(), device="cpu")          # only when asked
    assert eng.device.type == "cpu"


def test_kernel_sources_are_in_the_package_and_build_is_lazy():
    from repro_torch.kernels import _build
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"gather_swiglu.cu", "grouped_swiglu.cu", "moe_swiglu.cuh",
            "moe_tc_sm90.cuh", "gather_swiglu_q.cu", "grouped_swiglu_q.cu",
            "paged_attention.cu", "paged_attention_q.cu", "paged_attention.cuh",
            "flash_attention.cu", "swiglu_mlp.cu"} <= names
    assert {f"{n}.cu" for n in _build.KERNEL_SOURCES} == {
        n for n in names if n.endswith(".cu")}
    assert len(_build.KERNEL_SOURCES) == 8
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "build/" in gitignore


def test_kernel_sources_include_no_library_gemm_or_attention():
    """The kernels are hand-written: no csrc source includes cuBLAS, cuDNN
    or a CUTLASS device-level GEMM."""
    import re
    from repro_torch.kernels import _build
    banned = re.compile(r"cublas|cudnn|cutlass/gemm/device|cutlass/gemm/kernel"
                        r"|cutlass/gemm/collective", re.I)
    for p in sorted(_build.CSRC.iterdir()):
        for line in p.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert not banned.search(line), f"{p.name}: {line}"


def test_tensor_core_header_reaches_both_libraries(tmp_path, monkeypatch):
    """tc_sm90.cuh is included by swiglu_mlp.cu and flash_attention.cu and
    hashed into every library's name: an edit to it rebuilds them."""
    import shutil
    from repro_torch.kernels import _build
    for src in ("swiglu_mlp.cu", "flash_attention.cu"):
        assert '#include "tc_sm90.cuh"' in (_build.CSRC / src).read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = {n: _build._lib_path(n) for n in ("swiglu_mlp", "flash_attention")}
    assert _build._source_hash() == _build._source_hash()
    with open(copy / "tc_sm90.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: _build._lib_path(n) for n in before}
    assert all(before[n] != after[n] for n in before)
