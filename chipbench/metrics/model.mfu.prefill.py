"""Model operations of the measured window's prefills over the host wall
of those prefill calls at the bf16 peak."""
from chipbench import work

LAYER = "model"
UNIT = "%"
MOVES = "ttft_p95_s"
ENTRY = ("repro_torch/models/transformer.py::prefill",)
PROBES = ()


def read(rec):
    w = rec.window
    return 100.0 * w["prefill_flops"] / (w["prefill_wall_s"]
                                         * work.PEAK_BF16_FLOPS) \
        if w["prefills"] else None
