"""Attention at prefill: the causal-pair work of the traced window's
prompts (with MLA, the keys' and values' up-projection from the latents
too) at the roofline, over the device time of the operations launched
inside ``attend`` (a query of more than one position) or MLA's
``_naive``."""
from chipbench import probes, work

LAYER = "attention"
UNIT = "%"
MOVES = "ttft_p95_s"
ENTRY = ("repro_torch/models/attention.py::attend",
         "repro_torch/models/mla.py::_naive")
PROBES = (probes.MODEL_PREFILL, probes.ATTN_PREFILL_COUNT, probes.ATTEND,
          probes.MLA_NAIVE)


def read(rec):
    dev = rec.trace["device_s"].get("attn_prefill")
    got = rec.trace["work"].get("attn_prefill")
    if not dev or not got:
        return None
    return 100.0 * work.roofline_s(*got) / dev
