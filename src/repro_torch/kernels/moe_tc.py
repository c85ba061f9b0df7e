"""The routes and the tile plan of the bf16 MoE kernels ``gather_swiglu`` and
``grouped_swiglu`` (``csrc/moe_tc_sm90.cuh``).

Both kernels take the same route for the same ``(dtype, d, f)``
(:func:`route`), chosen before launch and counted per route:

* bf16 with d and f multiples of 8 -> ``tensor_core``: up to 64 rows of one
  expert a block on ``wgmma`` (bf16 in, fp32 accumulate), the expert's tables
  streamed through a ``cp.async`` ring once per column tile however many rows
  share them;
* anything else (fp32, or bf16 at other widths) -> ``cuda_core``: the kernels
  of ``csrc/moe_swiglu.cuh``, which take any width. On tensor cores fp32
  would become TF32, so fp32 stays there, bit for bit as before.

Both tensor-core kernels run one tile plan (:func:`plan`), a function of
(d, f, SM count) alone, never of T, k, the group sizes or the ids: the same
instruction shape over the same k-tiles in ascending order with the same
column tile, so a pair's row has the same bits from either kernel and at any
row count.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

ROUTES = ("tensor_core", "cuda_core")

#: csrc/moe_tc_sm90.cuh: kBM, kUpBN, kDownBN, kBK, kStages
M_TILE, UP_N_TILE, DOWN_N_TILE, K_TILE, STAGES = 64, 64, 128, 64, 3


@dataclasses.dataclass(frozen=True)
class Plan:
    """The tensor-core route's tiles: ``m_tile`` rows of one expert a block,
    output columns in tiles of ``up_n_tile`` (g and u over f) and
    ``down_n_tile`` (y over d), the reduction in steps of ``k_tile`` through a
    ring of ``stages`` shared-memory stages."""
    m_tile: int
    up_n_tile: int
    down_n_tile: int
    k_tile: int
    stages: int

    def args(self) -> Tuple[int, ...]:
        """The plan as the C entry points take it."""
        return (self.m_tile, self.up_n_tile, self.down_n_tile, self.k_tile,
                self.stages)

    def k_tiles(self, width: int) -> List[Tuple[int, int]]:
        """The [lo, hi) reduction steps over ``width`` (d up, f down), in the
        order every row runs them."""
        return [(lo, min(lo + self.k_tile, width))
                for lo in range(0, width, self.k_tile)]

    def column_tiles(self, width: int, n_tile: int) -> List[Tuple[int, int]]:
        """The [lo, hi) output columns of each block of a pass over
        ``width`` outputs in tiles of ``n_tile``."""
        return [(lo, min(lo + n_tile, width))
                for lo in range(0, width, n_tile)]


@functools.lru_cache(maxsize=None)
def plan(d: int, f: int, n_sms: int) -> Plan:
    """The tile plan of the tensor-core route for widths (d, f) on a card of
    ``n_sms`` SMs. One plan serves every width and the H100's 132 SMs: three
    blocks an SM of 64-column up tiles and 128-column down tiles give each
    expert that is hit f / 64 and d / 128 blocks, enough to fill the card at
    decode (about 49 experts) and at admission (all of them). On an H100
    a 64-column up tile ran faster than a 128-column one at both shapes
    (PERF.md §6)."""
    if d < 1 or f < 1 or n_sms < 1:
        raise ValueError(f"moe plan: d={d}, f={f}, n_sms={n_sms}")
    return Plan(m_tile=M_TILE, up_n_tile=UP_N_TILE, down_n_tile=DOWN_N_TILE,
                k_tile=K_TILE, stages=STAGES)


def route(dtype: torch.dtype, d: int, f: int) -> str:
    """``tensor_core`` for bf16 with d and f multiples of 8, ``cuda_core``
    for fp32 or other widths; raises for another dtype. Launches nothing."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"moe kernels: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "tensor_core"
    return "cuda_core"
