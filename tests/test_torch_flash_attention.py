"""The port's flash-attention plain version against the JAX package's
Pallas kernel (interpret mode) on the CPU, and the CUDA wrapper's checks.

Inputs are made with numpy from a seed and handed to both; bfloat16 inputs
are the same float32 values rounded by each framework (round to nearest
even, so the bits agree).  Tolerances are the reference's own: 3e-5 in
float32, 2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# (B, H, KV, S, hd, causal, window, softcap, dtype): tests/test_kernels.py
FLASH_CASES = [
    (1, 4, 2, 256, 64, True, None, 0.0, "float32"),
    (2, 4, 4, 128, 32, True, 64, 0.0, "float32"),
    (1, 2, 1, 192, 64, False, None, 0.0, "float32"),   # MQA + kv padding
    (1, 4, 2, 256, 64, True, None, 30.0, "float32"),   # softcap (gemma2)
    (1, 2, 2, 320, 128, True, 128, 50.0, "float32"),
    (1, 4, 2, 256, 64, True, None, 0.0, "bfloat16"),
    (1, 8, 2, 384, 128, True, None, 0.0, "bfloat16"),  # GQA group 4
]


def _inputs(case, seed=0):
    B, H, KV, S, hd, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_version_matches_pallas_kernel(case):
    B, H, KV, S, hd, causal, window, cap, dtype = case
    arrays = _inputs(case)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = flash_attention(*jx, causal=causal, window=window, softcap=cap,
                           block_q=128, block_k=128, interpret=True)
    got = ops.attention(*tx, causal=causal, window=window, softcap=cap)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == (B, H, S, hd)
    tol = 3e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_plain_version_takes_strided_views():
    """The model hands (B, S, H, hd) projections over as (B, H, S, hd)
    views; the result must not depend on the layout."""
    q, k, v = _inputs((2, 4, 2, 96, 32))
    tq, tk_, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = attention_ref(tq, tk_, tv, causal=True)
    got = attention_ref(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in (tq, tk_, tv)), causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 8, 48), (1, 2, 8, 48)), "head dim"),
    (((1, 4, 8, 64), (1, 3, 8, 64)), "kv heads"),
    (((1, 4, 8, 64), (1, 2, 8, 32)), "must be"),
    (((1, 4, 8, 64), (1, 2, 8, 64)), "CUDA"),
])
def test_kernel_wrapper_rejects(shapes, match):
    """The CUDA wrapper checks before it builds anything: what the kernel
    cannot take, and a CPU tensor, raise ValueError."""
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        tk.flash_attention(q, k, k)


def test_kernel_wrapper_rejects_dtypes():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tk.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        tk.flash_attention(q.float(), q.bfloat16(), q.bfloat16())
