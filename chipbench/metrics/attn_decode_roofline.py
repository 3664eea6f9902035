"""Attention at decode: the cache bytes at each row's valid length (with
MLA's absorbed form, the up-projection weights and the folds too) at the
roofline, over the device time of the operations launched inside
``attend`` with one query position (kernel K3) or MLA's
``_absorbed_decode``."""
from chipbench import probes, work

LAYER = "attention"
UNIT = "%"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/models/attention.py::attend",
         "repro_torch/models/mla.py::_absorbed_decode")
PROBES = (probes.MODEL_DECODE, probes.ATTN_DECODE_COUNT, probes.ATTEND,
          probes.MLA_ABSORBED)


def read(rec):
    dev = rec.trace["device_s"].get("attn_decode")
    got = rec.trace["work"].get("attn_decode")
    if not dev or not got:
        return None
    return 100.0 * work.roofline_s(*got) / dev
