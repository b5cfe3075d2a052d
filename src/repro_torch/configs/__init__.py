from repro_torch.configs.base import FedConfig

__all__ = ["FedConfig"]
