"""The plain references of the benchmark's architectures, one file a
architecture (``<arch>.py``, found by the ``arch`` of a configuration
file): plain PyTorch, float32, importing nothing of the program. Each has
``served_logits(cfg, weights, seqs, device, quant=None)``."""
