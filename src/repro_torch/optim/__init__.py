from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, adafactor, sgd, apply_updates, global_norm,
    cosine_schedule, make_optimizer, default_optimizer_for)
