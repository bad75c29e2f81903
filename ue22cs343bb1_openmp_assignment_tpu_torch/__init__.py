"""PyTorch/CUDA port of the cache-coherence simulator.

The JAX package ``ue22cs343bb1_openmp_assignment_tpu`` is the reference;
this package reproduces its deep-window transactional engine bit for bit
in PyTorch, with the per-node window fold as a hand-written CUDA kernel
for Hopper (``csrc/deep_fold.cu``). It imports neither JAX nor any
module of the JAX package: the jax-free modules it needs (config, types,
codec, trace and golden-dump I/O) are kept here as copies.

Entry points place state on ``device=None``, which means CUDA; with no
card they raise unless the caller asks for ``device="cpu"`` explicitly.
"""
