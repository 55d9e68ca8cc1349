"""Hand-written CUDA kernels for Hopper, each beside its plain torch version.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no switch between the two."""
