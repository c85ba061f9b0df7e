"""Continuous-batching serving engine of the port."""
from repro_torch.serving.engine import (Engine, EngineConfig, Request,
                                        poisson_trace)

__all__ = ["Engine", "EngineConfig", "Request", "poisson_trace"]
