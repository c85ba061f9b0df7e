"""What the port runs on: PyTorch, the card, the CUDA compiler."""
from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, Optional

import torch


def _run(cmd) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def gpu_line() -> Optional[str]:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (None without the tool or a card)."""
    if shutil.which("nvidia-smi") is None:
        return None
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def probe() -> Dict[str, Any]:
    """torch version, CUDA availability, device name and compute capability,
    the ``nvidia-smi`` name / power-limit line, ``nvcc --version``, and
    whether ``torch.mm`` returns fp32 from bf16 operands on the card."""
    from repro_torch.kernels import _build
    from repro_torch.models import numerics
    cuda = torch.cuda.is_available()
    info: Dict[str, Any] = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "compute_capability": (list(torch.cuda.get_device_capability(0))
                               if cuda else None),
        "nvidia_smi": gpu_line(),
        "nvcc": None,
        "mm_out_dtype": numerics.mm_out_dtype_available() if cuda else None,
    }
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is not None:
        ver = _run([nvcc, "--version"])
        info["nvcc"] = ver.splitlines()[-2:] if ver else None
    return info
