from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, MoEConfig,
                                      SSMConfig, ShapeSpec)

__all__ = ["INPUT_SHAPES", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeSpec"]
