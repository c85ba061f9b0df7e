"""The routes and the tile plan of the MoE kernels on Hopper's tensor cores:
the bf16 pair ``gather_swiglu`` / ``grouped_swiglu`` and the int8 pair
``gather_swiglu_q`` / ``grouped_swiglu_q`` (``csrc/moe_tc_sm90.cuh``).

The two kernels of a pair take the same route for the same ``(dtype, d, f)``
(:func:`route` for bf16 tables, :func:`route_q` for int8 ones), chosen
before launch and counted per route:

* bf16 activations with d and f multiples of 8 (bf16 tables) or 16 (int8
  tables) -> ``tensor_core``: up to 64 rows of one expert a block on
  ``wgmma`` (bf16 in, fp32 accumulate), the expert's tables streamed through
  a ``cp.async`` ring once per column tile however many rows share them. An
  int8 table arrives at half the bytes and is widened to bf16 in shared
  memory (exact); its scales are applied after the sums, and h crosses the
  passes as a bf16 hi + lo pair (about 16 bits of the fp32 h the reference
  keeps);
* anything else (fp32, or bf16 at other widths) -> ``cuda_core``: the kernels
  of ``csrc/moe_swiglu.cuh``, which take any width. On tensor cores fp32
  would become TF32, so fp32 stays there, bit for bit as before.

Both kernels of a pair run one tile plan (:func:`plan` for bf16 tables,
:func:`plan_q` for int8 ones: the same tiles, a shallower ring), a function
of (d, f, SM count) alone, never of T, k, the group sizes or the ids: the
same instruction shape over the same k-tiles in ascending order with the
same column tile, so a pair's row has the same bits from either kernel of a
pair and at any row count.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

ROUTES = ("tensor_core", "cuda_core")

#: csrc/moe_tc_sm90.cuh: kBM, kUpBN, kDownBN, kBK, kStages
M_TILE, UP_N_TILE, DOWN_N_TILE, K_TILE, STAGES = 64, 64, 128, 64, 3
#: csrc/moe_tc_sm90.cuh: kStagesQ, the ring depth with int8 tables
STAGES_Q = 2


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
    ``n_sms`` SMs, for both pairs. One plan serves every width and the
    H100's 132 SMs: three
    blocks an SM of 64-column up tiles and 128-column down tiles give each
    expert that is hit f / 64 and d / 128 blocks, enough to fill the card at
    decode (about 49 experts) and at admission (all of them). On an H100
    a 64-column up tile ran faster than a 128-column one at both shapes
    (PERF.md §6)."""
    if d < 1 or f < 1 or n_sms < 1:
        raise ValueError(f"moe plan: d={d}, f={f}, n_sms={n_sms}")
    return Plan(m_tile=M_TILE, up_n_tile=UP_N_TILE, down_n_tile=DOWN_N_TILE,
                k_tile=K_TILE, stages=STAGES)


@functools.lru_cache(maxsize=None)
def plan_q(d: int, f: int, n_sms: int) -> Plan:
    """The int8 pair's tile plan: :func:`plan`'s tiles with a ring of
    ``STAGES_Q`` stages. An int8 stage carries half a bf16 stage's weight
    bytes beside the same A tile, and its weights are widened in a staging
    tile; on an H100 two stages (four up-pass and three down-pass blocks an
    SM) ran faster than three at decode and at admission (PERF.md §6)."""
    return dataclasses.replace(plan(d, f, n_sms), stages=STAGES_Q)


def _route(dtype: torch.dtype, d: int, f: int, multiple: int,
           what: str) -> str:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    if dtype == torch.bfloat16 and d % multiple == 0 and f % multiple == 0:
        return "tensor_core"
    return "cuda_core"


def route(dtype: torch.dtype, d: int, f: int) -> str:
    """The bf16 pair's route: ``tensor_core`` for bf16 with d and f
    multiples of 8, ``cuda_core`` for fp32 or other widths; raises for
    another dtype. Launches nothing."""
    return _route(dtype, d, f, 8, "moe kernels")


def route_q(dtype: torch.dtype, d: int, f: int) -> str:
    """The int8 pair's route: ``tensor_core`` for bf16 activations with d and
    f multiples of 16 (an int8 tile row is copied 16 values at a time),
    ``cuda_core`` for fp32 or other widths; raises for another dtype.
    Launches nothing."""
    return _route(dtype, d, f, 16, "moe int8 kernels")
