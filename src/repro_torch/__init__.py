"""PyTorch/CUDA port of the Demeter system.

A package of its own beside ``repro`` (the JAX reference). It imports
``torch`` and never ``jax`` or ``repro``. It runs ``run_sweep`` for
baseline-controller and Demeter grids (``dsp/``, ``core/``) and serves the
dense decoders with Demeter autoscaling (``models/``, ``serving/``,
``launch/serve.py``). Its hand-written CUDA kernels are in ``csrc/``, built
at first use (``kernels/``).
"""
