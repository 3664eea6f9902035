"""The architectures' side of the benchmark, one file an architecture
(``<arch>.py``), found by the ``arch`` that a configuration file names.
Each has ``model_config(cfg)`` (the port's configuration), ``spec(cfg)``
(the weights a model holds: name, shape, scale of the draw),
``prefill_flops(cfg, n)`` and ``decode_flops(cfg, contexts)`` (the model
operations behind ``model.mfu``). Its plain reference is
``chipbench/reference/<arch>.py``."""
