"""Hand-written Hopper kernels of the port (sources in ``csrc/``).

Each family mirrors the JAX package's layout: ``kernel.py`` binds and
launches the CUDA kernel, ``ref.py`` is its plain PyTorch version, and
``ops.py`` is the wrapper the engine calls.  A wrapper checks its operands,
computes the plain version for tensors on the CPU, and for tensors on the
card launches the kernel (counting the launch in ``<wrapper>.launches``) or
raises.

  fused_update/     the approx step's leave-r-out parameter update
  lbfgs/            multidot and rank_update, the two passes of B v
  dequant_update/   the update and v = w - w_t on encoded history rows
  flash_attention/  the causal GQA attention forward of the LM
"""
