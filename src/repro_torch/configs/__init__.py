from repro_torch.configs.base import (FedConfig, MLAConfig, MoEConfig,
                                      ModelConfig, SSMConfig, ShapeConfig,
                                      XLSTMConfig, reduced)

__all__ = ["FedConfig", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
           "ShapeConfig", "XLSTMConfig", "reduced"]
