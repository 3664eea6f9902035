"""Share of the measured window's wall spent in prefill calls, while every
decoding row waits."""
LAYER = "engine"
UNIT = "%"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/serving/engine.py::ServingEngine._prefill_into_slot",)
PROBES = ()


def read(rec):
    w = rec.window
    return 100.0 * w["prefill_wall_s"] / w["seconds"] if w["prefills"] \
        else None
