"""Argument checks and launch counters shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import _build

#: dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: bytes of shared memory one block may ask for on sm_90
SMEM_LIMIT = 227 * 1024


class Kernel:
    """One hand-written kernel: its public name, its plain PyTorch version
    and ``LAUNCHES``, the number of times its wrapper launched it (never the
    plain version). A kernel with more than one route (a CUDA-core and a
    tensor-core entry point, chosen by dtype) also counts its launches per
    route in ``ROUTE_LAUNCHES``."""

    def __init__(self, name: str, plain: Callable, routes=("cuda_core",)):
        self.name = name
        self.plain = plain
        self.LAUNCHES = 0
        self.ROUTE_LAUNCHES = {r: 0 for r in routes}

    def count(self, route: str = "cuda_core") -> None:
        """One launch of ``route``'s kernel, called right after it."""
        self.ROUTE_LAUNCHES[route] += 1
        self.LAUNCHES += 1

    def reset(self) -> None:
        self.LAUNCHES = 0
        self.ROUTE_LAUNCHES = dict.fromkeys(self.ROUTE_LAUNCHES, 0)


_FNS: Dict[str, Callable] = {}


def launcher(symbol: str, n_ptr: int, n_int: int, tail=(),
             source: Optional[str] = None) -> Callable:
    """The C function ``symbol`` of ``csrc/<source>.cu`` (default: the symbol
    is ``<source>_launch``), built, loaded and bound at first use: ``n_ptr``
    pointers, ``n_int`` ints, then the ``tail`` types and the stream pointer,
    returning an int."""
    if symbol not in _FNS:
        lib = _build.load(source or symbol[:-len("_launch")])
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + list(tail) + [ctypes.c_void_p])
        _FNS[symbol] = fn
    return _FNS[symbol]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_x(name: str, x: torch.Tensor):
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected x [T, d], got {tuple(x.shape)}")


def _check_same_place(name: str, x: torch.Tensor, tensors) -> None:
    for nm, t in [("x", x)] + list(tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be 16-byte aligned")


def _table_shapes(name: str, x: torch.Tensor, wg: torch.Tensor):
    """(T, d, E, f) and the shape of every table and scale."""
    if wg.dim() != 3:
        raise ValueError(f"{name}: expected tables [E, d, f], got wg "
                         f"{tuple(wg.shape)}")
    T, d = x.shape
    E, d2, f = wg.shape
    if d2 != d or E < 1:
        raise ValueError(f"{name}: tables {tuple(wg.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    return (T, d, E, f), {"wg": (E, d, f), "wu": (E, d, f), "wd": (E, f, d),
                          "wg_scale": (E, 1, f), "wu_scale": (E, 1, f),
                          "wd_scale": (E, 1, d)}


def check_tables(name: str, x: torch.Tensor, wg: torch.Tensor,
                 wu: torch.Tensor, wd: torch.Tensor):
    """Validate activations and expert tables in x's type (wg/wu
    ``[E, d, f]``, wd ``[E, f, d]``), all contiguous, 16-byte aligned and on
    x's device; returns (T, d, E, f)."""
    _check_x(name, x)
    dims, shapes = _table_shapes(name, x, wg)
    tabs = (("wg", wg), ("wu", wu), ("wd", wd))
    for nm, t in tabs:
        if tuple(t.shape) != shapes[nm]:
            raise ValueError(f"{name}: {nm} is {tuple(t.shape)}, expected "
                             f"{shapes[nm]}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, x is {x.dtype}")
    _check_same_place(name, x, tabs)
    return dims


def check_qtables(name: str, x: torch.Tensor, qt):
    """Validate activations and int8 expert tables (``QuantizedExpertTables``:
    int8 ``[E, d, f]`` / ``[E, f, d]``, fp32 keepdim scales ``[E, 1, f]`` /
    ``[E, 1, d]``), all contiguous, 16-byte aligned and on x's device;
    returns (T, d, E, f)."""
    _check_x(name, x)
    dims, shapes = _table_shapes(name, x, qt.wg)
    tabs = [(nm, getattr(qt, nm)) for nm in shapes]
    for nm, t in tabs:
        dtype = torch.float32 if nm.endswith("_scale") else torch.int8
        if tuple(t.shape) != shapes[nm] or t.dtype != dtype:
            raise ValueError(f"{name}: {nm} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {shapes[nm]} {dtype}")
    _check_same_place(name, x, tabs)
    return dims


def n_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch refused, "
                           f"cudaGetLastError() = {code}")
