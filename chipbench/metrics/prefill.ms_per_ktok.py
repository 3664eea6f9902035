"""Host wall of the measured window's prefill calls per thousand prompt
tokens."""
LAYER = "model"
UNIT = "ms/ktok"
MOVES = "ttft_p95_s"
ENTRY = ("repro_torch/serving/engine.py::ServingEngine._prefill_into_slot",
         "repro_torch/models/transformer.py::prefill")
PROBES = ()


def read(rec):
    w = rec.window
    return 1e6 * w["prefill_wall_s"] / w["prompt_tokens"] \
        if w["prompt_tokens"] else None
