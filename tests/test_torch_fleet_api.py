"""The port's fleet API surface against the reference's (a port copy of
``tests/test_fleet_api.py`` under the port's names, plus the
differentials).

* the in-process ops, the default backend taken from ``EngineConfig``,
  the serving backend;
* uniform error shapes, with the reference's strings word for word;
* ``serve_jsonl`` in memory: the port's responses to a script equal the
  reference's, response for response;
* the real wire: a child ``python -m repro_torch.fleet --device cpu`` on
  stdio, its responses equal the reference's in-memory ones.
"""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402
import torch  # noqa: E402

from repro.fleet.api import FleetAPI as RefFleetAPI  # noqa: E402
from repro.fleet.api import serve_jsonl as ref_serve_jsonl  # noqa: E402
from repro.fleet.service import FleetConfig as RefFleetConfig  # noqa: E402
from repro_torch.core import EngineConfig  # noqa: E402
from repro_torch.fleet.api import FleetAPI, serve_jsonl  # noqa: E402
from repro_torch.fleet.service import FleetConfig  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet_kw(**kw):
    kw.setdefault("capacity", 4)
    kw.setdefault("profiling", False)
    return kw


def _api(**fleet_kw) -> FleetAPI:
    return FleetAPI(config=EngineConfig(device="cpu"),
                    fleet=FleetConfig(**_fleet_kw(**fleet_kw)))


def _ref_api(**fleet_kw) -> RefFleetAPI:
    return RefFleetAPI(fleet=RefFleetConfig(**_fleet_kw(**fleet_kw)))


class TestInProcess:
    def test_register_report_epoch_recommend(self):
        api = _api()
        r = api.handle({"op": "register_job", "job_id": "a",
                        "backend": "sim"})
        assert r["ok"] and r["row"] == 0 and r["backend"] == "sim"
        r = api.handle({"op": "report_telemetry", "job_id": "a", "t": 30.0,
                        "metrics": {"rate": 500.0, "latency": 1.2,
                                    "usage": 0.5}})
        assert r["ok"] and r["accepted"]
        r = api.handle({"op": "run_epoch"})
        assert r["ok"] and r["epoch"] == 1 and r["observed"] == 1
        r = api.handle({"op": "recommend", "job_id": "a"})
        assert r["ok"] and r["policy"] == "cold"
        assert r["epochs_observed"] == 1
        r = api.handle({"op": "stats"})
        assert r["ok"] and r["jobs"] == 1
        r = api.handle({"op": "deregister_job", "job_id": "a"})
        assert r["ok"]
        assert api.handle({"op": "stats"})["jobs"] == 0

    def test_default_backend_comes_from_engine_config(self):
        api = _api()
        assert api.controller.config.fleet_backend == "sim"
        r = api.handle({"op": "register_job", "job_id": "a"})
        assert r["ok"] and r["backend"] == "sim"
        serving = FleetAPI(config=EngineConfig(device="cpu",
                                               fleet_backend="serving"),
                           fleet=FleetConfig(**_fleet_kw()))
        r = serving.handle({"op": "register_job", "job_id": "s"})
        assert r["ok"] and r["backend"] == "serving"

    def test_fleet_backend_is_validated(self):
        with pytest.raises(ValueError, match="unknown fleet backend 'x'; "
                           r"available: \('serving', 'sim'\)"):
            EngineConfig(device="cpu", fleet_backend="x")

    def test_serving_backend_registers(self):
        api = _api()
        r = api.handle({"op": "register_job", "job_id": "s",
                        "backend": "serving",
                        "params": {"decode_step_s": 0.01}})
        assert r["ok"] and r["backend"] == "serving"
        rec = api.handle({"op": "recommend", "job_id": "s"})
        assert rec["ok"] and "replicas" in rec["config"]
        ref = _ref_api()
        ref.handle({"op": "register_job", "job_id": "s",
                    "backend": "serving", "params": {"decode_step_s": 0.01}})
        assert rec == ref.handle({"op": "recommend", "job_id": "s"})

    def test_serving_job_runs_epochs_with_the_reference(self):
        """A serving job stepped and reported for 8 epochs (it warms after
        5) gives the reference's responses."""
        out = []
        for a in (_api(cold_start_min_obs=2),
                  _ref_api(cold_start_min_obs=2)):
            a.handle({"op": "register_job", "job_id": "s",
                      "backend": "serving",
                      "params": {"decode_step_s": 0.05, "prefill_s": 0.1}})
            ex = a.controller.job("s").executor
            resp = []
            for epoch in range(8):
                for k in range(12):
                    ex.step(40.0 + 30.0 * (epoch % 3))
                m = ex.observe()
                resp.append(a.handle({"op": "report_telemetry",
                                      "job_id": "s", "t": 60.0 * epoch + 30,
                                      "metrics": m}))
                resp.append(a.handle({"op": "run_epoch"}))
            resp.append(a.handle({"op": "recommend", "job_id": "s"}))
            resp.append(a.handle({"op": "stats"}))
            out.append(resp)
        assert out[0] == out[1]
        assert out[0][-2]["policy"] == "demeter"

    def test_error_shapes_are_uniform_and_the_reference_s(self):
        api, ref = _api(), _ref_api()
        for req in ({"op": "frobnicate"},
                    {"op": None},
                    {"op": "recommend", "job_id": "ghost"},
                    {"op": "register_job"},                 # missing job_id
                    {"op": "register_job", "job_id": "x",
                     "backend": "not-a-backend"},
                    {"op": "register_job", "job_id": "x",
                     "params": {"bogus": 1}},
                    {"op": "register_job", "job_id": "x",
                     "backend": "serving", "params": {"bogus": 1}},
                    {"op": "report_telemetry", "job_id": "x", "t": 1.0,
                     "metrics": {}},
                    {"op": "report_telemetry", "job_id": "x"},
                    {"op": "deregister_job", "job_id": "x"}):
            r = api.handle(req)
            assert r["ok"] is False and isinstance(r["error"], str), req
            assert r == ref.handle(req), req

    def test_unknown_backend_error_names_available(self):
        r = _api().handle({"op": "register_job", "job_id": "x",
                           "backend": "bogus"})
        assert not r["ok"] and "sim" in r["error"]
        assert r["error"] == ("register_job: unknown fleet backend 'bogus'; "
                              "available: ('serving', 'sim')")

    def test_capacity_error_is_the_reference_s(self):
        api, ref = _api(capacity=1), _ref_api(capacity=1)
        for a in (api, ref):
            a.handle({"op": "register_job", "job_id": "a"})
        req = {"op": "register_job", "job_id": "b"}
        assert api.handle(req) == ref.handle(req)
        assert "at capacity" in api.handle(req)["error"]

    def test_default_api_is_on_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FleetAPI(fleet=FleetConfig(capacity=2))


#: one script through both packages: registrations of both backends,
#: telemetry, malformed JSON, errors, epochs, deregistration, shutdown
SCRIPT = [
    {"op": "register_job", "job_id": "a", "backend": "sim"},
    {"op": "register_job", "job_id": "b", "backend": "sim",
     "params": {"seed": 3}},
    {"op": "register_job", "job_id": "s", "backend": "serving",
     "params": {"decode_step_s": 0.03, "prefill_s": 0.08}},
    {"op": "report_telemetry", "job_id": "a", "t": 30.0,
     "metrics": {"rate": 500.0, "latency": 1.5, "usage": 0.5}},
    {"op": "report_telemetry", "job_id": "b", "t": 40.0,
     "metrics": {"rate": 900.0, "latency": 9.0, "usage": 0.95}},
    "this is not json",
    {"op": "run_epoch"},
    {"op": "recommend", "job_id": "a"},
    {"op": "recommend", "job_id": "b"},
    {"op": "nope"},
    {"op": "deregister_job", "job_id": "a"},
    {"op": "register_job", "job_id": "c"},
    {"op": "run_epoch"},
    {"op": "stats"},
    {"op": "shutdown"},
    {"op": "stats"},                           # never reached
]


def _lines(script):
    return "\n".join(r if isinstance(r, str) else json.dumps(r)
                     for r in script) + "\n"


class TestJsonLines:
    def test_serve_jsonl_in_memory(self):
        out = io.StringIO()
        served = serve_jsonl(_api(), io.StringIO(_lines(SCRIPT)), out)
        responses = [json.loads(line) for line in
                     out.getvalue().strip().splitlines()]
        assert served == len(SCRIPT) - 1          # stopped at shutdown
        assert responses[0]["ok"] and responses[0]["row"] == 0
        assert not responses[5]["ok"] \
            and "bad json" in responses[5]["error"]
        assert responses[6]["ok"] and responses[6]["epoch"] == 1
        assert responses[-1] == {"ok": True, "shutdown": True}

    def test_serve_jsonl_equals_reference(self):
        outs = []
        for serve, api in ((serve_jsonl, _api()),
                           (ref_serve_jsonl, _ref_api())):
            buf = io.StringIO()
            serve(api, io.StringIO(_lines(SCRIPT)), buf)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
        assert len(outs[0].splitlines()) == len(SCRIPT) - 1

    def test_subprocess_round_trip(self):
        """The real wire: a child ``python -m repro_torch.fleet --device
        cpu`` on stdio, answering as the reference does in memory."""
        env = os.environ.copy()
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO_ROOT / "src")]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.fleet", "--capacity", "4",
             "--no-profiling", "--device", "cpu"],
            input=_lines(SCRIPT), env=env, cwd=str(REPO_ROOT),
            capture_output=True, text=True, timeout=600.0)
        assert proc.returncode == 0, proc.stderr
        ref = io.StringIO()
        ref_serve_jsonl(_ref_api(), io.StringIO(_lines(SCRIPT)), ref)
        assert proc.stdout == ref.getvalue()
        responses = [json.loads(line) for line in proc.stdout.splitlines()]
        assert responses[1]["ok"] and responses[1]["row"] == 1
        stats = responses[-2]
        assert stats["ok"] and stats["jobs"] == 3 \
            and len(stats["decision_digest"]) == 64
        assert responses[-1] == {"ok": True, "shutdown": True}
