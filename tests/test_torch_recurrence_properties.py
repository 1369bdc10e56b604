"""The reference's recurrence property sweeps (``tests/test_recurrence_
properties.py``) held against the port: for each drawn seed and length,
one set of weights (the port's initializer, seeded) and one input, as
numpy arrays, go through the port's Mamba-2 SSD and RG-LRU blocks, whose
prefill over the first half then per-token decode must equal their full
scan at every position, and through the reference's blocks (jitted, one
compile a length), whose full scan the port's must equal — all within the
reference file's 2e-4 (float32).  ``max_examples`` are the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.models import rglru as JR  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssd as TS  # noqa: E402

TOL = 2e-4
SSD = dict(d_inner=32, state=8, nheads=4, chunk=4)
_ref_ssd = jax.jit(lambda p, x: JS.ssd_block(p, x, **SSD)[0])
_ref_rglru = jax.jit(lambda p, x: JR.rglru_block(p, x)[0])


def _inputs(init, seed, shape, **kw):
    """(the port's weights, the same as jnp arrays, x as a tensor, x as
    numpy) from ``seed``."""
    tp = init(torch.Generator().manual_seed(seed), shape[-1],
              dtype=torch.float32, **kw)
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.5
         ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, convert._map(tp, convert.to_numpy))
    return tp, jp, torch.from_numpy(x), x


def _decode_matches_scan(block, tp, tx, split, **kw):
    """The port's block: (full scan, prefill of ``split`` tokens then one
    decode step at a time), both (B, T, D)."""
    state_kw = "rec_state" if block is TS.ssd_block else "state"
    with torch.inference_mode():
        y_full, _ = block(tp, tx, **kw)
        y, st_ = block(tp, tx[:, :split], return_final_state=True, **kw)
        ys = [y]
        for t in range(split, tx.shape[1]):
            y, st_ = block(tp, tx[:, t:t + 1], **{state_kw: st_}, **kw)
            ys.append(y)
    return y_full, torch.cat(ys, dim=1)


@given(st.integers(0, 10_000), st.integers(6, 20))
@settings(max_examples=8, deadline=None)
def test_ssd_decode_matches_scan(seed, T):
    tp, jp, tx, x = _inputs(TS.ssd_init, seed, (1, T, 16), conv_width=4,
                            **{k: v for k, v in SSD.items() if k != "chunk"})
    y_full, y_inc = _decode_matches_scan(TS.ssd_block, tp, tx, T // 2, **SSD)
    np.testing.assert_allclose(y_inc.numpy(), y_full.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(_ref_ssd(jp, x)),
                               atol=TOL, rtol=TOL)


@given(st.integers(0, 10_000), st.integers(6, 24))
@settings(max_examples=8, deadline=None)
def test_rglru_decode_matches_scan(seed, T):
    tp, jp, tx, x = _inputs(TR.rglru_init, seed, (2, T, 12), width=16,
                            conv_width=4)
    y_full, y_inc = _decode_matches_scan(TR.rglru_block, tp, tx, T // 2)
    np.testing.assert_allclose(y_inc.numpy(), y_full.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(_ref_rglru(jp, x)),
                               atol=TOL, rtol=TOL)
