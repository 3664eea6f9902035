"""MoE experts during decodes: the larger of the operations and the
bytes of the kept assignments and the experts they reach (their weights
read once a call) at the roofline, over the device time of the operations
launched inside ``_routed_sorted`` (the sort, the three K6 products, the
activation and the gather back)."""
from chipbench import probes, work

LAYER = "MoE experts"
UNIT = "%"
MOVES = "output_tokens_per_s"
ENTRY = ("repro_torch/models/moe.py::_routed_sorted",)
PROBES = (probes.MODEL_PREFILL, probes.MODEL_DECODE, probes.MOE_EXPERTS)


def read(rec):
    dev = rec.trace["device_s"].get("moe_experts.decode")
    kept = rec.trace["counts"].get("experts.kept.decode")
    if not dev or not kept:
        return None
    reached = rec.trace["counts"]["experts.reached.decode"]
    return 100.0 * work.roofline_s(*work.experts_work(rec.cfg, kept,
                                                      reached)) / dev
