from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.configs.registry import get_config, list_archs, reduced_config

__all__ = ["ModelConfig", "ParallelConfig", "get_config", "list_archs", "reduced_config"]
