"""The 95th percentile, over the requests whose first token fell in the
measured window, of first token minus submit: ``ttft_p95_s`` in a cell
where it swings too widely to hold a bound (many rows, so several serial
prefills queue behind one another in a step)."""
LAYER = "engine"
UNIT = "s"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/serving/engine.py::ServingEngine._prefill_into_slot",)
PROBES = ()


def read(rec):
    return rec.e2e.get("ttft_p95_s")
