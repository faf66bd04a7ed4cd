"""DeltaGrad (Wu, Dobriban, Davidson, ICML 2020) on PyTorch and CUDA.

The PyTorch counterpart of the JAX package `repro`, module for module.  The
main path is Algorithm 1 (train with a cached path, BaseL, DeltaGrad
replay) with the approx step's parameter-length passes in CUDA kernels
written for Hopper (`kernels/`, sources in `csrc/`).  Entry points run on
the card unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper computes its plain PyTorch version.
"""
