"""The port's chunked-SSD plain version against the JAX package's Pallas
kernel (interpret mode) on the CPU, and the CUDA wrapper's checks.

Inputs are made with numpy from a seed and handed to both.  Tolerances are
the reference's own: 1e-4 in float32, 5e-2 in bfloat16, on y and on the
final state.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402

# (B, T, H, P, N, chunk, dtype): tests/test_kernels.py
SSD_CASES = [
    (2, 128, 4, 32, 64, 32, "float32"),
    (1, 256, 8, 64, 128, 64, "float32"),
    (1, 128, 2, 16, 32, 16, "bfloat16"),
]


def _inputs(B, T, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    Bm = (rng.standard_normal((B, T, N)) * 0.3).astype(f32)
    Cm = (rng.standard_normal((B, T, N)) * 0.3).astype(f32)
    return x, dt, A, Bm, Cm


def _both(arrays, dtype):
    x, dt, A, Bm, Cm = arrays
    jx = (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(Bm).astype(dtype), jnp.asarray(Cm).astype(dtype))
    td = getattr(torch, dtype)
    tx = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).to(td),
          torch.from_numpy(Cm).to(td))
    return jx, tx


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_version_matches_pallas_kernel(case):
    B, T, H, P, N, chunk, dtype = case
    jx, tx = _both(_inputs(B, T, H, P, N), dtype)
    y, st = ssd_scan(*jx, chunk, interpret=True)
    ty, tst = ops.ssd(*tx, chunk=chunk)
    assert ty.dtype == tst.dtype == tx[0].dtype
    assert tuple(ty.shape) == (B, T, H, P)
    assert tuple(tst.shape) == (B, H, P, N)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for got, want in ((ty, y), (tst, st)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_state_feeds_decode():
    """The final state equals the reference's, so a prefill through the
    kernel hands off to the recurrent decode path (test_kernels.py's
    state-feeds-decode case), and a state carried in continues the scan."""
    B, T, H, P, N, chunk = 1, 64, 2, 16, 32, 16
    jx, tx = _both(_inputs(B, T, H, P, N, seed=1), "float32")
    _, st_k = ssd_scan(*jx, chunk, interpret=True)
    _, st_t = ops.ssd(*tx, chunk=chunk)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_k), atol=1e-5)
    # two halves with the state carried across == one pass
    half = T // 2
    first = [t[:, :half] if t.dim() > 1 else t for t in tx]
    second = [t[:, half:] if t.dim() > 1 else t for t in tx]
    _, mid = ssd_ref(*first, chunk)
    y2, st2 = ssd_ref(*second, chunk, init_state=mid)
    jy2, jst2 = jssd_ref(*[jnp.asarray(t.numpy()) for t in second], chunk,
                         init_state=jnp.asarray(mid.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-5)
    np.testing.assert_allclose(st2.numpy(), np.asarray(jst2), atol=1e-5)
    np.testing.assert_allclose(st2.numpy(), st_t.numpy(), atol=1e-5)


@pytest.mark.parametrize("dims,chunk,match", [
    ((1, 48, 2, 16, 32), 16, "CUDA"),          # valid shapes, CPU tensors
    ((1, 40, 2, 16, 32), 16, "multiple of chunk"),
    ((1, 48, 2, 24, 32), 16, "P=24"),
    ((1, 48, 2, 80, 32), 16, "P=80"),
    ((1, 48, 2, 16, 144), 16, "N=144"),
    ((1, 48, 2, 16, 40), 16, "N=40"),
    ((1, 48, 2, 16, 32), 24, "chunk 24"),
    ((1, 512, 2, 16, 32), 512, "chunk 512"),
])
def test_kernel_wrapper_rejects(dims, chunk, match):
    """The CUDA wrapper checks before it builds anything."""
    _, tx = _both(_inputs(*dims), "float32")
    with pytest.raises(ValueError, match=match):
        tk.ssd_scan(*tx, chunk)


def test_kernel_wrapper_rejects_dtypes():
    _, (x, dt, A, Bm, Cm) = _both(_inputs(1, 32, 2, 16, 16), "float32")
    with pytest.raises(ValueError, match="float32"):
        tk.ssd_scan(x, dt.double(), A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="dtype"):
        tk.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, 16)
