"""Continuous-batching serving engine of the port."""
from repro_torch.serving.engine import (Engine, EngineConfig, Request,
                                        poisson_trace)
from repro_torch.serving.spec import accept_drafts

__all__ = ["Engine", "EngineConfig", "Request", "accept_drafts",
           "poisson_trace"]
