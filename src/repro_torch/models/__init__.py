"""Model substrate in PyTorch: every family of the reference — dense, MoE,
recurrent (RWKV-6, RG-LRU hybrid), VLM (patch prefix, prefix-LM) and
encoder-decoder."""
from .api import ModelApi, build_model
from .common import ModelConfig, MoEConfig, count_params
from .convert import (load_reference_master, load_reference_params,
                      master_params, working_params)

__all__ = ["ModelApi", "build_model", "ModelConfig", "MoEConfig",
           "count_params", "load_reference_master", "load_reference_params",
           "master_params", "working_params"]
