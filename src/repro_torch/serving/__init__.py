"""Continuous-batching serving engine of the port, and its deterministic
fault injection (DESIGN.md §12)."""
from repro_torch.serving.engine import (Engine, EngineConfig, Request,
                                        poisson_trace)
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.spec import accept_drafts

__all__ = ["Engine", "EngineConfig", "FaultPlan", "FaultSpec", "Request",
           "accept_drafts", "poisson_trace"]
