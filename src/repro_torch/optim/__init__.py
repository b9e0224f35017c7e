"""Optimizers and learning-rate schedules of the zoo's training."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, momentum, sgd)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["Optimizer", "adafactor", "adam", "adamw", "clip_by_global_norm",
           "global_norm", "make_optimizer", "momentum", "sgd",
           "cosine_warmup"]
