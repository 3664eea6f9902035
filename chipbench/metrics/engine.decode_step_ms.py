"""Host wall of a decode step: every ``ServingEngine.step`` of the
measured window, timed from outside, over the steps."""
LAYER = "engine"
UNIT = "ms"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/serving/engine.py::ServingEngine.step",)
PROBES = ()


def read(rec):
    w = rec.window
    return 1e3 * w["step_wall_s"] / w["steps"] if w["steps"] else None
