"""The port's fused-tick kernel family against the reference's.

The plain versions are held against the reference: the tick
(``repro_torch.kernels.ref.fused_tick_ref``) against the Pallas kernel run
in interpret mode, the interval (``fused_interval_ref``) against the
reference's ``fused_interval_scan`` with and without the Pallas tick. The
dispatch rules of ``repro_torch.kernels.ops`` are checked, and the nvcc
command the loader would run is inspected. The CUDA kernels themselves run
only on the card: ``tests/test_torch_cuda.py`` (marker ``cuda``) and
``chip_smoke.py`` hold them against the plain versions there.
"""
import contextlib
import dataclasses

import jax
import jax.experimental

# Workaround for JAX 0.9.0, which dropped ``jax.experimental.enable_x64``
# while the reference still imports it from there. Set before any ``repro``
# import; no file of the reference is edited.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.dsp import fused as jfused  # noqa: E402
from repro.dsp import simulator as jsim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_tick import fused_tick as pallas_fused_tick  # noqa: E402
from repro_torch.dsp.simulator import ClusterModel, step_batch_arrays  # noqa: E402
from repro_torch.interop import cluster_model_from_dict  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import fused_tick as cuda_fused_tick  # noqa: E402
from repro_torch.kernels.ref import (METRIC_KEYS,  # noqa: E402
                                     fused_interval_ref, fused_tick_ref,
                                     rls_rank1_update_ref)

LAM, THRESH, DT = 0.995, 3.0, 5.0
NAMES = ("new_lag", "w'", "P'", "err", "flag")


def _operands(n, seed):
    """NumPy operands shaped like the reference's TestFusedTick._operands."""
    rng = np.random.default_rng(seed)
    return dict(
        lag=rng.uniform(0.0, 1e5, n),
        lag_add=rng.uniform(0.0, 1e4, n),
        rates=rng.uniform(1e4, 9e4, n),
        cap=rng.uniform(1e4, 8e4, n),
        down_pre=rng.random(n) < 0.3,
        w=rng.normal(size=(n, 2)) * 0.1,
        P=np.broadcast_to(10.0 * np.eye(2), (n, 2, 2)).copy(),
        y_prev=rng.uniform(0.0, 12.0, n),
    )


def _torch(ops_np, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in ops_np.items()}


@pytest.mark.parametrize("n", [3, 8, 37])   # sub-block, exact, ragged
def test_plain_fused_tick_matches_pallas_kernel(n):
    ops_np = _operands(n, seed=n)
    with jax.experimental.enable_x64():
        want = pallas_fused_tick(**{k: jnp.asarray(v) for k, v in
                                    ops_np.items()},
                                 lam=LAM, thresh=THRESH, dt=DT,
                                 interpret=True)
        want = [np.asarray(x) for x in want]
    got = [t.numpy() for t in fused_tick_ref(**_torch(ops_np), lam=LAM,
                                             thresh=THRESH, dt=DT)]
    for g, r, name in zip(got[:4], want[:4], NAMES):
        assert g.dtype == np.float64, name
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(got[4], want[4], err_msg="flag")


@pytest.mark.parametrize("n", [3, 16, 37])
def test_plain_lag_update_is_step_batch_arrays_bit_for_bit(n):
    # The fused engine takes its lag carry from the tick and its metrics
    # from step_batch_arrays: the two must agree exactly, not approximately.
    t = _torch(_operands(n, seed=100 + n))
    rows = torch.ones(n, dtype=torch.float64)
    z = torch.zeros(n, dtype=torch.float64)
    new_lag, m = step_batch_arrays(
        ClusterModel(), t["lag"], t["lag_add"], t["rates"], rows * 4.0, rows,
        rows * 4096.0, rows, t["cap"], t["down_pre"], t["down_pre"], z, z, DT)
    tick_lag = fused_tick_ref(**t, lam=LAM, thresh=THRESH, dt=DT)[0]
    np.testing.assert_array_equal(tick_lag.numpy(), new_lag.numpy())
    np.testing.assert_array_equal(tick_lag.numpy(),
                                  m["consumer_lag"].numpy())


@pytest.mark.parametrize("n", [1, 5, 33])
def test_plain_rls_update_matches_reference_oracle(n):
    rng = np.random.default_rng(n)
    k = 3
    A = rng.normal(size=(n, k, k))
    P = A @ A.transpose(0, 2, 1) + np.eye(k)
    phi = rng.normal(size=(n, k))
    lam = rng.uniform(0.9, 1.0, n)
    with jax.experimental.enable_x64():
        want = [np.asarray(x) for x in jref.rls_rank1_update_ref(
            jnp.asarray(P), jnp.asarray(phi), jnp.asarray(lam))]
    got = rls_rank1_update_ref(torch.from_numpy(P), torch.from_numpy(phi),
                               torch.from_numpy(lam))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    t = _torch(_operands(8, seed=1))
    got = ops.fused_tick(**t, lam=LAM, thresh=THRESH, dt=DT)
    want = fused_tick_ref(**t, lam=LAM, thresh=THRESH, dt=DT)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_ops_raises_for_a_meta_tensor():
    t = _torch(_operands(4, seed=2), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.fused_tick(**t, lam=LAM, thresh=THRESH, dt=DT)


def test_cuda_wrapper_refuses_cpu_tensors():
    # The kernel wrapper never computes on the CPU: the plain version is
    # reached only through ops' device dispatch.
    t = _torch(_operands(4, seed=3))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_fused_tick.fused_tick(**t, lam=LAM, thresh=THRESH, dt=DT)


def _interval_operands(S, K, seed):
    """NumPy operands of one fused-engine interval: state mid-run, mixed
    configs, rows down before and after each tick (down_post implies a
    zero z2, as the host precomputes it) and rollback lag on some ticks."""
    rng = np.random.default_rng(seed)
    down_pre = rng.random((K, S)) < 0.15
    down_post = down_pre & (rng.random((K, S)) < 0.7)
    z2 = np.abs(rng.normal(size=(K, S)))
    z2[down_post] = 0.0
    P = np.broadcast_to(10.0 * np.eye(2), (S, 2, 2)).copy()
    P += rng.uniform(-0.5, 0.5, (S, 1, 1)) * (1.0 - np.eye(2))
    return dict(
        lag=rng.uniform(0.0, 2e5, S) * (rng.random(S) < 0.6),
        det_w=rng.normal(size=(S, 2)) * 0.1, det_p=P,
        det_y=rng.uniform(0.0, 12.0, S),
        det_trig=rng.integers(0, 5, S).astype(np.int64),
        rates=rng.uniform(1e4, 9e4, (K, S)),
        lag_add=rng.uniform(0.0, 5e4, (K, S)) * (rng.random((K, S)) < 0.1),
        down_pre=down_pre, down_post=down_post,
        z1=rng.normal(size=(K, S)), z2=z2,
        workers=rng.integers(1, 25, S).astype(np.float64),
        cpu_cores=rng.integers(1, 5, S).astype(np.float64),
        memory_mb=rng.choice([1024.0, 2048.0, 4096.0], S),
        task_slots=rng.integers(1, 4, S).astype(np.float64),
        cap_base=rng.uniform(1e4, 8e4, S))


STATE = ("lag", "det_w", "det_p", "det_y", "det_trig")


#: How the reference's ``fused_interval_scan`` runs in the interval test:
#: (use_pallas, under ``jax.disable_jit``). Eagerly, its jnp oracle rounds
#: each operation on its own, as the port's plain version does, and the
#: two agree bit for bit. Compiled (as the reference runs it), XLA's CPU
#: backend contracts and rewrites the scan body (``processed / dt``
#: becomes a product with the reciprocal, products and sums fuse), and the
#: Pallas tick in interpret mode is compiled even under ``disable_jit``:
#: the reference's own lag carry then differs from its own metrics by an
#: ulp, so those two are held at 1e-12 of each metric's scale.
REFERENCE_RUNS = {"oracle-eager": (False, True),
                  "oracle-compiled": (False, False),
                  "pallas-interpret": (True, True)}


@pytest.mark.parametrize("run", sorted(REFERENCE_RUNS))
@pytest.mark.parametrize("K", [1, 12, 33])
def test_plain_fused_interval_matches_reference_scan(K, run):
    """The interval's plain version against the reference's
    ``fused_interval_scan`` on 37 rows with down rows and rollback lag:
    lag and all nine metrics bit for bit against the eager oracle (else
    1e-12, see ``REFERENCE_RUNS``), the detector's ``w``, ``P`` and ``y``
    at 1e-12 and the trigger counts equal."""
    S = 37
    use_pallas, eager = REFERENCE_RUNS[run]
    a = _interval_operands(S, K, seed=10 * K + use_pallas)
    jmodel = jsim.ClusterModel()
    model = cluster_model_from_dict(dataclasses.asdict(jmodel))
    with jax.experimental.enable_x64(), \
            (jax.disable_jit() if eager else contextlib.nullcontext()):
        j = {k: jnp.asarray(v) for k, v in a.items()}
        carry, jm = jfused.fused_interval_scan(
            jmodel, *(j[k] for k in STATE), j["rates"], j["lag_add"],
            j["down_pre"], j["down_post"], j["z1"], j["z2"],
            jnp.ones(K, bool), j["workers"], j["cpu_cores"], j["memory_mb"],
            j["task_slots"], j["cap_base"], LAM, THRESH, DT, use_pallas)
        want_state = [np.asarray(x) for x in carry]
        want_m = {k: np.asarray(v).astype(np.float64) for k, v in jm.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    got = fused_interval_ref(model, *(t[k] for k in STATE), t["rates"],
                             t["lag_add"], t["down_pre"], t["down_post"],
                             t["z1"], t["z2"], t["workers"], t["cpu_cores"],
                             t["memory_mb"], t["task_slots"], t["cap_base"],
                             LAM, THRESH, DT)
    assert got.shape == (len(METRIC_KEYS), K, S)
    assert got.dtype == torch.float64
    pairs = [(key, got[q].numpy(), want_m[key])
             for q, key in enumerate(METRIC_KEYS)]
    pairs.append(("lag", t["lag"].numpy(), want_state[0]))
    for name, g, r in pairs:
        if run == "oracle-eager":
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-12,
                                       atol=1e-12 * np.abs(r).max(),
                                       err_msg=name)
    for name, g, r in zip(STATE[1:4], (t["det_w"], t["det_p"], t["det_y"]),
                          want_state[1:4]):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(t["det_trig"].numpy(), want_state[4])


def _interval_tensors(a, device="cpu"):
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in a.items()}


def _interval_args(t):
    return (ClusterModel(), *(t[k] for k in STATE), t["rates"], t["lag_add"],
            t["down_pre"], t["down_post"], t["z1"], t["z2"], t["workers"],
            t["cpu_cores"], t["memory_mb"], t["task_slots"], t["cap_base"],
            LAM, THRESH, DT)


def test_ops_routes_cpu_intervals_to_the_plain_version():
    a = _interval_operands(9, 5, seed=4)
    got_t, want_t = _interval_tensors(a), _interval_tensors(a)
    got = ops.fused_interval(*_interval_args(got_t))
    want = fused_interval_ref(*_interval_args(want_t))
    assert torch.equal(got, want)
    for k in STATE:
        assert torch.equal(got_t[k], want_t[k]), k


def test_interval_dispatch_refuses_other_devices_and_cpu_in_the_wrapper():
    # ops raises on a device it does not know; the kernel wrapper never
    # computes on the CPU (the plain version is reached through ops only)
    meta = _interval_tensors(_interval_operands(4, 2, seed=5), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.fused_interval(*_interval_args(meta))
    cpu = _interval_tensors(_interval_operands(4, 2, seed=5))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_fused_tick.fused_interval(*_interval_args(cpu))
    assert "fused_interval_launch" in build.SIGNATURES["fused_tick"]


def test_nvcc_command_targets_hopper_without_fma_contraction(tmp_path):
    src = build.CSRC_DIR / "fused_tick.cu"
    cmd = build.nvcc_command("nvcc", src, tmp_path / "lib.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd
    assert "-shared" in cmd and str(src) in cmd
    assert src.is_file()
    # the library lands under the checkout's ignored build/ directory
    lib = build.library_path("fused_tick")
    assert lib.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")



def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """A source may include any header in ``csrc/`` (``hopper.cuh``: TMA,
    mbarriers, wgmma), so the library's name hashes every header with the
    source: a changed header means a new library, built afresh."""
    for f in ("grouped_matmul.cu", "hopper.cuh"):
        (tmp_path / f).write_bytes((build.CSRC_DIR / f).read_bytes())
    assert '#include "hopper.cuh"' in (tmp_path / "grouped_matmul.cu"
                                       ).read_text()
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("grouped_matmul")
    assert build.library_path("grouped_matmul") == before   # stable
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    changed = build.library_path("grouped_matmul")
    assert changed != before and changed.parent == build.BUILD_DIR
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("grouped_matmul") != changed
