"""FEEL round configuration (the paper's Table I) and the model configs
of the LM task and the decoder-only zoo. The public names are the JAX
package's ``repro.configs.__all__``."""
from repro_torch.configs.base import (FeelConfig, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, SHAPES,
                                      SSMConfig, TrainConfig)
from repro_torch.configs.registry import ARCHS, get, grid, list_archs, reduced

__all__ = ["FeelConfig", "InputShape", "MLAConfig", "ModelConfig", "MoEConfig",
           "SHAPES", "SSMConfig", "TrainConfig", "ARCHS", "get", "grid",
           "list_archs", "reduced"]
