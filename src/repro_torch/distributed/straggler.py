"""Straggler detection + restart policy.

Under SPMD every collective is a barrier, so a slow chip stalls the fleet;
the mitigation at scale is LAUNCHER-level: detect persistent step-time
regression, drain the job, and relaunch on a spare slice (the elastic
checkpoint restore in repro.ckpt makes the relaunch cheap). This module is
the detector + policy half; ``launch.train`` consumes it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration_s: float
    median_s: float
    ratio: float
    is_straggler: bool
    consecutive: int
    should_restart: bool


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x rolling median; recommends a
    drain/relaunch after ``patience`` consecutive flagged steps."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 patience: int = 5, warmup: int = 3):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.patience = patience
        self.warmup = warmup
        self.consecutive = 0
        self._step = 0
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self) -> StragglerReport:
        assert self._t0 is not None, "start_step() not called"
        dur = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dur)

    def observe(self, duration_s: float) -> StragglerReport:
        self._step += 1
        if len(self.window) >= self.warmup:
            med = sorted(self.window)[len(self.window) // 2]
            ratio = duration_s / max(med, 1e-9)
            is_straggler = ratio > self.threshold
        else:
            med, ratio, is_straggler = duration_s, 1.0, False
        self.consecutive = self.consecutive + 1 if is_straggler else 0
        # slow steps are NOT added to the window (they'd poison the median)
        if not is_straggler:
            self.window.append(duration_s)
        return StragglerReport(
            step=self._step, duration_s=duration_s, median_s=med,
            ratio=ratio, is_straggler=is_straggler,
            consecutive=self.consecutive,
            should_restart=self.consecutive >= self.patience)
