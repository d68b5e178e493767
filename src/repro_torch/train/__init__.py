"""Training of the LM substrate, ported from the JAX package's ``train/``:
AdamW with a warmup+cosine schedule, and the train step."""
from .optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .step import (TrainState, make_train_step, make_init_state, loss_fn,
                   state_from_numpy)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "TrainState", "make_train_step", "make_init_state", "loss_fn",
           "state_from_numpy"]
