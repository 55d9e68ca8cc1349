"""PyTorch/CUDA port of the Fast Distributed PageRank reproduction.

Mirrors the JAX package `repro` module for module; the JAX package is the
reference it is tested against. Entry points run on the CUDA card unless
the caller passes `device="cpu"`. Each kernel is CUDA C++ for Hopper,
built from `kernels/*/*.cu` at first use; CPU tensors take the kernels'
plain torch versions. Beside the paper's engines the port holds the JAX
package's LM serving path: the decoder-only transformer family and its
VLM (`configs`, `models`) behind `serve.ContinuousBatcher`.
"""
