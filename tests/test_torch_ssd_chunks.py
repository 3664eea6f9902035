"""K5's chunked algorithm and its dispatch, on the CPU.

The SSD-scan kernel (``csrc/ssd_scan.cu``) runs in three passes: every
chunk's own state, the states passed from chunk to chunk in order, and
every chunk's output by tiles of 64 rows. What can be checked without a
card:

* the algorithm in plain torch (``kernels/ref.py::ssd_scan_chunked_ref``)
  against K5's plain version (``ssd_scan_ref``), the reference's
  ``ssd_chunked_reference`` and its Pallas ``ssd_scan`` in interpret mode,
  from the same seeded NumPy inputs: ``tests/test_torch_ssm.py``'s SSD
  shapes, chunks of 20 (no tile divides it) and 16, a one-chunk and a
  16-chunk sequence, in float32 at atol and rtol 5e-5, the reference's
  bar (``SSD_BARS``); and under strong decay (A up to 16, dt up to 1),
  where exp(cum_i - cum_j) would overflow above the diagonal, against
  the plain version at the same bar. (There the reference's two
  versions sum the log-decay in another order than torch.cumsum does;
  with |cum| in the thousands, their y differs from the port's plain
  version by up to four times the bar, while the chunked algorithm stays
  within a fiftieth of it.)
* ``kernels/ssd_scan.py::design`` against the C entry point's dispatch,
  for every (dtype, P, N, chunk) the wrapper takes: the tensor-core body
  for bfloat16 at P = 64 and N = 32, 64 or 128, the CUDA-core one
  otherwise.
"""
import importlib
import math

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

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ref import (ssd_scan_chunked_ref,  # noqa: E402
                                     ssd_scan_ref)
#: the kernels' modules (each wrapper of the package shadows its own)
kmod = importlib.import_module("repro_torch.kernels.ssd_scan")

TOL = 5e-5         # float32: the reference's bar, atol and rtol
#: (B, S, H, P, G, N, chunk): tests/test_torch_ssm.py's SSD shapes, a
#: chunk of 20, the smoke configs' 16, one chunk, sixteen chunks
SHAPES = [(2, 512, 4, 64, 1, 128, 128), (1, 256, 8, 64, 2, 128, 256),
          (2, 256, 4, 64, 4, 128, 128), (1, 100, 3, 32, 1, 32, 20),
          (2, 64, 4, 16, 1, 16, 16), (1, 256, 4, 64, 1, 128, 256),
          (1, 256, 2, 32, 1, 64, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor operations run fastest on one thread; several test
    workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, p, g, n, seed, strong):
    rng = np.random.default_rng(seed)
    a_max, dt_max = (math.log(16), 1.0) if strong else (1.5, 0.1)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.001, dt_max, (b, s, h)).astype(np.float32),
            rng.uniform(0, a_max, (h,)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


def _agree(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_chunked_algorithm_matches_plain_reference_and_pallas(
        b, s, h, p, g, n, chunk):
    arrays = _inputs(b, s, h, p, g, n, seed=s + h + g + chunk,
                     strong=False)
    got = ssd_scan_chunked_ref(*map(torch.from_numpy, arrays), chunk)
    jax_in = tuple(map(jnp.asarray, arrays))
    for want in (ssd_scan_ref(*map(torch.from_numpy, arrays), chunk),
                 ref_mamba2.ssd_chunked_reference(*jax_in, chunk=chunk),
                 pallas_ssd_scan(*jax_in, chunk=chunk, interpret=True)):
        _agree(got, want)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_chunked_algorithm_under_strong_decay(b, s, h, p, g, n, chunk):
    """No NaN from exp above the diagonal; the plain version's y and
    final state within the bar."""
    arrays = _inputs(b, s, h, p, g, n, seed=s + h + g + chunk, strong=True)
    got = ssd_scan_chunked_ref(*map(torch.from_numpy, arrays), chunk)
    assert got[0].isfinite().all() and got[1].isfinite().all()
    _agree(got, ssd_scan_ref(*map(torch.from_numpy, arrays), chunk))


def test_chunked_algorithm_rounds_y_to_the_input_dtype():
    arrays = _inputs(1, 128, 2, 16, 1, 16, seed=1, strong=False)
    args = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16()
    y, state = ssd_scan_chunked_ref(*args, 64)
    want_y, want_state = ssd_scan_ref(*args, 64)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), want_state.numpy(), atol=TOL,
                               rtol=TOL)
    # one bf16 rounding either way
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd_scan_chunked_ref(*args, 48)


def _dispatch() -> str:
    source = (build.CSRC_DIR / "ssd_scan.cu").read_text()
    return " ".join(source[source.index('extern "C" int ssd_scan_launch'):]
                    .split())


@pytest.mark.parametrize("chunk", [16, 20, 64, 256])
@pytest.mark.parametrize("N", kmod.STATE_DIMS)
@pytest.mark.parametrize("P", kmod.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_names_the_c_dispatch(dtype, P, N, chunk):
    """bfloat16 at P = 64 and N = 32, 64 or 128 (mamba2's and zamba2's
    shapes) takes the tensor-core body, every other (dtype, P, N) the
    CUDA-core one, whatever the chunk: the wrapper's ``design`` names what
    the C entry point's dispatch launches."""
    name = kmod.design(dtype, P, N, chunk)
    tc = dtype == torch.bfloat16 and P == 64 and N in (32, 64, 128)
    assert name == ("tensor-cores" if tc else "cuda-cores")
    dispatch = _dispatch()
    code = kmod._DTYPES[dtype]
    # the C dispatch sends this (dtype, P, N) to launch_tc<N> exactly when
    # the wrapper names the tensor-core body ...
    branch = (f"if (dtype == {code} && P == {P} && N == {N}) "
              f"return launch_tc<{N}>")
    assert (branch in dispatch) == tc
    # ... and every other case to the CUDA-core instantiation of its dtype,
    # which has a case for this P and N
    t = "float" if code == 0 else "__nv_bfloat16"
    assert f"if (dtype == {code}) return launch_p<{t}>" in dispatch
    source = (build.CSRC_DIR / "ssd_scan.cu").read_text()
    assert f"case {P}: return launch_n<T, {P}>" in source
    assert f"case {N}: return launch<T, P, {N}>" in source


@pytest.mark.parametrize("P,N,dtype", [(48, 128, torch.float32),
                                       (64, 256, torch.bfloat16),
                                       (64, 128, torch.float16)])
def test_design_refuses_shapes_the_kernel_does_not_take(P, N, dtype):
    with pytest.raises((ValueError, TypeError)):
        kmod.design(dtype, P, N, 64)
