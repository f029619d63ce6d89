"""Model substrate in PyTorch: the dense, MoE and recurrent (RWKV-6,
RG-LRU hybrid) families."""
from .api import ModelApi, build_model
from .common import ModelConfig, MoEConfig, count_params
from .convert import load_reference_params

__all__ = ["ModelApi", "build_model", "ModelConfig", "MoEConfig",
           "count_params", "load_reference_params"]
