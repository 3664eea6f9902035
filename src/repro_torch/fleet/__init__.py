"""Fleet-controller service mode: a continuous Demeter loop over many jobs.

Instead of one offline sweep, a long-lived :class:`FleetController` runs
the paper's two processes continuously over thousands of concurrently
registered jobs, with per-job forecaster and detector state held in shared
banks on the device (one batched call per epoch whatever the fleet's
size), shared GP fits across due controllers, cold-start graceful
degradation and a JSON-lines API surface (:mod:`repro_torch.fleet.api`).
:mod:`repro_torch.fleet.loadgen` soaks the service with synthetic jobs
replaying the sweep grid's workload generators.
"""
from .api import FleetAPI, serve_jsonl
from .ingest import INGEST_KEYS, IngestBuffer
from .loadgen import SoakConfig, run_soak
from .service import FleetConfig, FleetController, JobState

__all__ = [
    "FleetController", "FleetConfig", "JobState",
    "IngestBuffer", "INGEST_KEYS",
    "FleetAPI", "serve_jsonl",
    "SoakConfig", "run_soak",
]
