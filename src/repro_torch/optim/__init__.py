from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                         apply_updates, clip_by_global_norm,
                                         clip_scale, constant_schedule,
                                         global_norm, make_optimizer,
                                         momentum, sgd,
                                         warmup_cosine_schedule)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "clip_scale", "constant_schedule",
           "global_norm", "make_optimizer", "momentum", "sgd",
           "warmup_cosine_schedule"]
