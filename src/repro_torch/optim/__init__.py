from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                         make_optimizer, momentum, sgd)

__all__ = ["Optimizer", "apply_updates", "make_optimizer", "momentum", "sgd"]
