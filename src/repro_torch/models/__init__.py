"""The LM substrate's models, ported from the JAX package's ``models/``:
configs, layers, MoE, RG-LRU, xLSTM and the functional ``Model``."""
from .config import ModelConfig, MoEConfig, LAYERS_PER_KIND
from .transformer import (Model, build_model, block_init, block_apply,
                          params_from_numpy)
from .partition import partitioning, hint, split_meta, resolve_spec

__all__ = ["ModelConfig", "MoEConfig", "LAYERS_PER_KIND", "Model",
           "build_model", "block_init", "block_apply", "partitioning",
           "hint", "split_meta", "resolve_spec"]
