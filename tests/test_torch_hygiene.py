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


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_forbidden_import_or_call(path):
    text = path.read_text()
    tree = ast.parse(text)
    for node in ast.walk(tree):
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
    assert {"gather_swiglu.cu", "grouped_swiglu.cu", "moe_swiglu.cuh"} <= names
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "build/" in gitignore
