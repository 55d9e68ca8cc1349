from repro_torch.train.optimizer import (AdamState, AdamWConfig,
                                         apply_updates, init_state,
                                         state_axes)
from repro_torch.train.train_step import make_train_step
from repro_torch.train.compression import compressed_psum, compression_error

__all__ = ["AdamState", "AdamWConfig", "apply_updates", "init_state",
           "make_train_step", "compressed_psum", "compression_error",
           "state_axes"]
