from repro_torch.kernels.walk_step.ops import walk_step, walk_step_keyed

__all__ = ["walk_step", "walk_step_keyed"]
