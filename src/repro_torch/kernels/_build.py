"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them.

Each ``<name>.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``build/`` beside this file and
loaded with ``ctypes``. The
file name carries a hash of every source under ``csrc/`` and of the compiler
flags, so an edit rebuilds. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("gather_swiglu", "grouped_swiglu", "gather_swiglu_q",
                  "grouped_swiglu_q", "paged_attention", "paged_attention_q",
                  "flash_attention", "swiglu_mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parent / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME / "
        "/usr/local/cuda): the CUDA kernels of repro_torch cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_source_hash()}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> List[Path]:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` each, all started together. Returns the library paths."""
    names = list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib)
    return [_lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            (path,) = build([name])
            _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[name]
