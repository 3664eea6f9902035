"""Model operations of every token the measured window processed (each
prompt token and decoded token through the layers, attention at its real
context, the LM head once a sampled token) over the window's wall at the
bf16 peak."""
from chipbench import work

LAYER = "model"
UNIT = "%"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/models/transformer.py::prefill",
         "repro_torch/models/transformer.py::decode_step")
PROBES = ()


def read(rec):
    w = rec.window
    flops = w["prefill_flops"] + w["decode_flops"]
    return 100.0 * flops / (w["seconds"] * work.PEAK_BF16_FLOPS) \
        if flops else None
