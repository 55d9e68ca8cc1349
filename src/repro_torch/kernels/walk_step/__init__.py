from repro_torch.kernels.walk_step.ops import (walk_step, walk_step_keyed,
                                               walk_step_keyed_)

__all__ = ["walk_step", "walk_step_keyed", "walk_step_keyed_"]
