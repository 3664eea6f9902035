"""PyTorch/CUDA port of the Demeter sweep stack.

A package of its own beside ``repro`` (the JAX reference). It imports
``torch`` and never ``jax`` or ``repro``. This slice runs ``run_sweep`` for
baseline-controller grids (static / reactive / ds2) on the batched NumPy
engine and on the fused engine, whose per-tick work is the hand-written
CUDA kernel in ``csrc/fused_tick.cu``.
"""
