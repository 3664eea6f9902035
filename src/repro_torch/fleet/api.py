"""The fleet service's request/response surface.

Two faces over one :class:`~repro_torch.fleet.service.FleetController`:

* **in-process**: construct :class:`FleetAPI` and call
  :meth:`FleetAPI.handle` with plain dicts (or reach through
  ``api.controller`` for the typed surface and pass executor *objects* to
  ``register_job`` directly);
* **JSON lines**: :func:`serve_jsonl` reads one request object per line and
  writes one response object per line, so a subprocess or socket peer
  drives the same surface (``python -m repro_torch.fleet``).

Remote peers name job backends by their
:data:`repro_torch.core.registry.FLEET_BACKENDS` entry (``{"op":
"register_job", "backend": "sim", ...}``); the factory builds the executor
and configuration space server-side. The two built-in backends:

``"sim"``
    a :class:`repro_torch.dsp.executor.DSPExecutor` over the paper's
    Flink-style cluster model and
    :func:`~repro_torch.core.config_space.paper_flink_space`;
``"serving"``
    a :class:`repro_torch.serving.autoscale.ServingExecutor` over a replica
    fleet with a synthetic (or measured) profile and
    :func:`~repro_torch.core.config_space.tpu_serving_space`.
"""
from __future__ import annotations

import json
import sys
from typing import IO, Dict, Mapping, Optional, Tuple

from ..core.config_space import ConfigSpace
from ..core.executor import EngineConfig, Executor
from ..core.registry import FLEET_BACKENDS
from .service import FleetConfig, FleetController

# ---------------------------------------------------------------------------
# registered job backends
# ---------------------------------------------------------------------------


@FLEET_BACKENDS.register("sim")
def sim_backend(*, seed: int = 0, **params
                ) -> Tuple[Executor, ConfigSpace]:
    """One simulated Flink-style job (the paper's target system)."""
    from ..core.config_space import paper_flink_space
    from ..dsp.executor import DSPExecutor
    from ..dsp.simulator import ClusterModel, JobConfig
    model_kw = {k: params.pop(k) for k in list(params)
                if hasattr(ClusterModel, k)}
    if params:
        raise ValueError(f"unknown sim backend params: {sorted(params)}")
    ex = DSPExecutor(ClusterModel(**model_kw), JobConfig(), seed=int(seed))
    return ex, paper_flink_space()


@FLEET_BACKENDS.register("serving")
def serving_backend(*, seed: int = 0, decode_step_s: float = 0.02,
                    prefill_s: float = 0.05, base_slots: int = 8,
                    **params) -> Tuple[Executor, ConfigSpace]:
    """One serving replica fleet behind the Demeter executor protocol.

    The default replica profile is synthetic; pass measured
    ``decode_step_s`` / ``prefill_s`` (from
    :func:`repro_torch.serving.autoscale.calibrate`) to ground it in real
    engine timings.
    """
    from ..core.config_space import tpu_serving_space
    from ..serving.autoscale import (ClusterModelParams, ReplicaProfile,
                                     ServingCluster, ServingExecutor)
    model_kw = {k: params.pop(k) for k in list(params)
                if hasattr(ClusterModelParams, k)}
    if params:
        raise ValueError(f"unknown serving backend params: {sorted(params)}")
    profile = ReplicaProfile(float(decode_step_s), float(prefill_s),
                             int(base_slots))
    cluster = ServingCluster(profile, ClusterModelParams(**model_kw),
                             seed=int(seed))
    return ServingExecutor(cluster), tpu_serving_space()


def _sim_contract_probe(device: str = "cuda"):
    # The fleet's batched hot path is the epoch ingestion reduce; it is
    # backend-independent, so the default backend carries its contract.
    from .ingest import contract_probe
    return contract_probe(device)


def _serving_contract_probe(device: str = "cuda"):
    from ..analysis.contracts import host_probe
    return host_probe(
        "fleet backend:serving",
        "per-job queueing dynamics are host-side NumPy; the fleet's batched "
        "call (the ingestion reduce) is pinned on the 'sim' entry")


FLEET_BACKENDS.attach_contract("sim", _sim_contract_probe)
FLEET_BACKENDS.attach_contract("serving", _serving_contract_probe)


# ---------------------------------------------------------------------------
# request/response surface
# ---------------------------------------------------------------------------

class FleetAPI:
    """Dict-in / dict-out facade over a :class:`FleetController`.

    Every response carries ``"ok"``; failures carry ``"error"`` instead of
    raising, so the JSON-lines transport and in-process callers see one
    uniform error shape. ``config=None`` is ``EngineConfig()``, whose
    device is the card.
    """

    def __init__(self, controller: Optional[FleetController] = None, *,
                 config: Optional[EngineConfig] = None,
                 fleet: Optional[FleetConfig] = None):
        self.controller = controller if controller is not None \
            else FleetController(config=config, fleet=fleet)

    # -- ops ----------------------------------------------------------------
    def _op_register_job(self, req: Mapping) -> Dict:
        job_id = req["job_id"]
        backend = req.get("backend", self.controller.config.fleet_backend)
        factory = FLEET_BACKENDS.get(backend)
        params = dict(req.get("params", {}))
        params.setdefault("seed", self.controller.fleet.seed)
        executor, space = factory(**params)
        row = self.controller.register_job(job_id, executor, space,
                                           backend=backend)
        return {"ok": True, "job_id": job_id, "row": row,
                "backend": backend}

    def _op_deregister_job(self, req: Mapping) -> Dict:
        self.controller.deregister_job(req["job_id"])
        return {"ok": True, "job_id": req["job_id"]}

    def _op_report_telemetry(self, req: Mapping) -> Dict:
        accepted = self.controller.report_telemetry(
            req["job_id"], float(req["t"]), dict(req["metrics"]))
        return {"ok": True, "accepted": accepted}

    def _op_run_epoch(self, req: Mapping) -> Dict:
        summary = self.controller.run_epoch()
        return {"ok": True, **summary}

    def _op_recommend(self, req: Mapping) -> Dict:
        return {"ok": True, **self.controller.recommend(req["job_id"])}

    def _op_stats(self, req: Mapping) -> Dict:
        return {"ok": True, **self.controller.stats()}

    def _op_shutdown(self, req: Mapping) -> Dict:
        return {"ok": True, "shutdown": True}

    _OPS = {
        "register_job": _op_register_job,
        "deregister_job": _op_deregister_job,
        "report_telemetry": _op_report_telemetry,
        "run_epoch": _op_run_epoch,
        "recommend": _op_recommend,
        "stats": _op_stats,
        "shutdown": _op_shutdown,
    }

    def handle(self, request: Mapping) -> Dict:
        op = request.get("op")
        handler = self._OPS.get(op)
        if handler is None:
            return {"ok": False,
                    "error": f"unknown op {op!r}; "
                             f"available: {sorted(self._OPS)}"}
        try:
            return handler(self, request)
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            detail = f"missing field {e}" if isinstance(e, KeyError) else str(e)
            return {"ok": False, "error": f"{op}: {detail}"}


def serve_jsonl(api: FleetAPI, stdin: Optional[IO[str]] = None,
                stdout: Optional[IO[str]] = None) -> int:
    """Serve JSON-lines requests until EOF or a ``shutdown`` op.

    One request object per input line, one response object per output
    line, flushed per response (a subprocess peer must never deadlock on
    buffering). Malformed JSON yields an error response, not a crash.
    Returns the number of requests served.
    """
    fin = stdin if stdin is not None else sys.stdin
    fout = stdout if stdout is not None else sys.stdout
    served = 0
    for line in fin:
        line = line.strip()
        if not line:
            continue
        try:
            request = json.loads(line)
        except json.JSONDecodeError as e:
            response: Dict = {"ok": False, "error": f"bad json: {e}"}
            request = None
        else:
            response = api.handle(request)
        fout.write(json.dumps(response, sort_keys=True) + "\n")
        fout.flush()
        served += 1
        if request is not None and request.get("op") == "shutdown":
            break
    return served


def main(argv: Optional[list] = None) -> int:
    """``python -m repro_torch.fleet``: a JSON-lines fleet service on stdio."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--capacity", type=int, default=64,
                    help="maximum concurrent jobs (default 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-profiling", action="store_true",
                    help="disable the profiling process")
    ap.add_argument("--device", default="cuda",
                    help="where the banks and the ingest reduce run "
                         "(default cuda; cpu to run without a card)")
    args = ap.parse_args(argv)
    api = FleetAPI(config=EngineConfig(device=args.device),
                   fleet=FleetConfig(capacity=args.capacity, seed=args.seed,
                                     profiling=not args.no_profiling))
    serve_jsonl(api)
    return 0
