"""Optimizers and schedules (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (Optimizer, OptState, adamw,
                                          apply_updates, clip_by_global_norm,
                                          make_optimizer, sgd)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         linear_warmup)
