"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch
versions (:mod:`.ref`), dispatched by device in :mod:`.ops`. Building a
kernel happens at its first launch, never at import."""
