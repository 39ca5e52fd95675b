"""SWAPPER on PyTorch and CUDA: the port of the ``repro`` JAX package.

The sub-packages keep the JAX package's names (``configs``, ``core``,
``kernels``, ``quant``, ``models``, ``serve``) so every module has an obvious
counterpart.  The port imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  On a
CUDA tensor every kernel wrapper launches its hand-written kernel (or
raises); the plain PyTorch version beside it runs only for CPU tensors.
"""
