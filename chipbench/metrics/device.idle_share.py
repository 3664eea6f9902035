"""Share of the traced window's wall in which no operation ran on the
device: 1 - busy / wall, busy the union of the device operations'
intervals in the profiler's trace."""
from chipbench import probes

LAYER = "device"
UNIT = "%"
MOVES = "output_tokens_per_s"
ENTRY = ()
PROBES = (probes.MODEL_PREFILL, probes.MODEL_DECODE, probes.MOE_ROUTE)


def read(rec):
    t = rec.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] \
        else None
