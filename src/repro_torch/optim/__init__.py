from repro_torch.optim.optimizers import (Optimizer, adafactor, adam,
                                          get_optimizer, sgd, sgdm_bf16)

__all__ = ["Optimizer", "adafactor", "adam", "sgd", "sgdm_bf16",
           "get_optimizer"]
