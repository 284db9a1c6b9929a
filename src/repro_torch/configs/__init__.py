"""Configuration dataclasses (the port's own copy; see ``configs.base``)."""
from repro_torch.configs.base import FaultConfig, FederatedConfig

__all__ = ["FaultConfig", "FederatedConfig"]
