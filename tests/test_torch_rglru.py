"""The torch port's RG-LRU block (``models/rglru.py``) and the encoder's
sinusoidal positions against the JAX package on the CPU: the same seeded
numpy inputs and the reference's weights (carried across by
``params_from_jax``'s leaf converter) through both.

The port's scan is a Hillis–Steele pass over time, the reference's
``jax.lax.associative_scan`` a tree: the same combine in another order, so
float32 results agree to rounding (1e-4, the model tests' ``TOL``), and
bf16 ones within the reference's bf16 kernel tolerance (2e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
D, W = 24, 32


def _params(dtype, seed=0):
    jp = JR.rglru_init(jax.random.PRNGKey(seed), D, width=W, conv_width=4,
                       dtype=jnp.dtype(dtype))
    return jp, convert._map(jax.tree.map(np.asarray, jp), convert.to_torch)


def _x(shape, dtype, seed=1, scale=0.5):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype, what):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], err_msg=what)


def test_init_shapes_and_lam_stay_float32_in_bf16():
    jp, _ = _params("bfloat16")
    tp = TR.rglru_init(torch.Generator().manual_seed(0), D, width=W,
                       conv_width=4, dtype=torch.bfloat16)
    for k, want in jax.tree.map(np.asarray, jp).items():
        got = tp[k]
        if isinstance(want, dict):
            assert tuple(got["w"].shape) == want["w"].shape, k
            assert got["w"].dtype == torch.bfloat16
            continue
        assert tuple(got.shape) == want.shape, k
    assert tp["lam"].dtype == torch.float32 and jp["lam"].dtype == jnp.float32
    # a = exp(-c·softplus(Λ)) in (0.9, 0.999) at r = 1, as the reference's
    a = torch.exp(-TR.RGLRU_C * torch.nn.functional.softplus(tp["lam"]))
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())


@pytest.mark.parametrize("T", [1, 2, 7, 64, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_reference(T, with_h0):
    jp, tp = _params("float32")
    jx, tx = _x((2, T, W), "float32")
    jh, th = _x((2, W), "float32", seed=2) if with_h0 else (None, None)
    jy, jhf = JR.rglru_scan(jp, jx, jh)
    ty, thf = TR.rglru_scan(tp, tx, th)
    _close(ty, jy, "float32", f"scan y T={T}")
    _close(thf, jhf, "float32", f"scan h_final T={T}")


def test_scan_is_the_sequential_recurrence_over_a_long_prompt():
    """4096 steps with decays near 1 (a cumulative product of a would
    reach ~1e-18 and be no use): the log-depth scan equals the step-by-step
    recurrence in float64."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.98, 1.0, (2, 4096, 8))).float()
    b = torch.from_numpy(rng.standard_normal((2, 4096, 8))).float()
    h, want = torch.zeros((2, 8), dtype=torch.float64), []
    for t in range(4096):
        h = a[:, t].double() * h + b[:, t].double()
        want.append(h)
    got = TR.linear_scan(a, b)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_step_matches_reference():
    jp, tp = _params("float32")
    jx, tx = _x((3, 1, W), "float32")
    jh, th = _x((3, W), "float32", seed=4)
    jy, jnh = JR.rglru_step(jp, jx, jh)
    ty, tnh = TR.rglru_step(tp, tx, th)
    _close(ty, jy, "float32", "step y")
    _close(tnh, jnh, "float32", "step h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_prefill_then_decode_matches_reference(dtype):
    """The block over the whole sequence, and split: a prefill that
    returns the state, then one decode step at a time (the reference's
    ``test_rglru_decode_matches_scan``), each output and each carried
    state against the reference's."""
    jp, tp = _params(dtype, seed=5)
    T, split = 13, 6
    jx, tx = _x((2, T, D), dtype, seed=6)
    jy, _ = JR.rglru_block(jp, jx)
    with torch.inference_mode():
        ty, none = TR.rglru_block(tp, tx)
    assert none is None
    _close(ty, jy, dtype, "block full")
    jy, jst = JR.rglru_block(jp, jx[:, :split], return_final_state=True)
    with torch.inference_mode():
        ty, tst = TR.rglru_block(tp, tx[:, :split], return_final_state=True)
    _close(ty, jy, dtype, "block prefill")
    for t in range(split, T):
        for k in ("h", "conv"):
            assert tst[k].dtype == getattr(torch, dtype), k
            _close(tst[k], jst[k], dtype, f"state {k} before step {t}")
        jy, jst = JR.rglru_block(jp, jx[:, t:t + 1], state=jst)
        with torch.inference_mode():
            ty, tst = TR.rglru_block(tp, tx[:, t:t + 1], state=tst)
        _close(ty, jy, dtype, f"decode step {t}")


def test_block_state_shape_and_short_prompt_conv_tail():
    """A prompt shorter than the conv's history: the tail carries the
    zero padding, as the reference's does."""
    jp, tp = _params("float32")
    jx, tx = _x((1, 2, D), "float32", seed=7)
    _, jst = JR.rglru_block(jp, jx, return_final_state=True)
    _, tst = TR.rglru_block(tp, tx, return_final_state=True)
    shapes = TR.rglru_state_shape(1, W, 4)
    for k in ("h", "conv"):
        assert tuple(tst[k].shape) == shapes[k] == jst[k].shape
        _close(tst[k], jst[k], "float32", k)
    assert bool((tst["conv"][:, 0] == 0).all())


def test_scan_gradient_matches_reference():
    """Autograd through the scan against ``jax.grad`` of the reference's."""
    jp, tp = _params("float32", seed=8)
    jx, tx = _x((2, 19, W), "float32", seed=9)
    jg = jax.grad(lambda x: jnp.sum(JR.rglru_scan(jp, x)[0] ** 2))(jx)
    tx.requires_grad_(True)
    (TR.rglru_scan(tp, tx)[0] ** 2).sum().backward()
    _close(tx.grad, jg, "float32", "scan gradient")


@pytest.mark.parametrize("length,d", [(16, 64), (7, 6), (1500, 768)])
def test_sinusoidal_embed_matches_reference(length, d):
    """Row 0 (sin 0 = 0, cos 0 = 1) and the layout (sin in the even
    columns, cos in the odd ones) bit for bit; every other entry within
    two float32 spacings of its position plus two of 1.0.  Not bit-equal
    throughout: XLA's CPU exp, sin and cos are its own approximations
    (neither libm's nor PyTorch's), and a last bit of a frequency or of a
    sine differs in some entries; a frequency's last bit, times the
    position, moves the argument by up to a spacing of the position."""
    want = np.asarray(JL.sinusoidal_embed(length, d))
    got = TL.sinusoidal_embed(length, d).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (length, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0, 0::2], 0.0)
    np.testing.assert_array_equal(got[0, 1::2], 1.0)
    arg = np.arange(length, dtype=np.float32)[:, None]
    bound = 2 * np.spacing(np.maximum(arg, 1.0)) + 2 * np.spacing(
        np.float32(1.0))
    assert bool((np.abs(got - want) <= bound).all())
