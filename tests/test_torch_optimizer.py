"""The torch port's optimizer against the JAX package on the CPU: AdamW
(a quadratic, the clip, bfloat16 moments), the LR schedules, and int8 and
top-k gradient compression over the reference's stacked leaves, all fed
the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # the property test needs the dev extra
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.reduced import reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optimizer import adamw as JA  # noqa: E402
from repro.optimizer import compression as JC  # noqa: E402
from repro.optimizer import schedule as JS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optimizer import adamw as TA  # noqa: E402
from repro_torch.optimizer import compression as TC  # noqa: E402
from repro_torch.optimizer import schedule as TS  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- AdamW ----------------------------------------------------------------------

def _quadratic(n_steps, opt_kw, dtype=np.float32, scale=1.0):
    """Both packages' AdamW on sum((w - t)^2) · scale from the same start;
    the gradient 2·(w - t)·scale is computed by each package."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(3, 5)).astype(np.float32) * 4
    target = rng.normal(size=(3, 5)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jstate_dtype = opt_kw.pop("state_dtype", None)
    jopt = JA.AdamW(**opt_kw, state_dtype=jstate_dtype and jnp.bfloat16)
    topt = TA.AdamW(**opt_kw, state_dtype=jstate_dtype and torch.bfloat16)
    jp = {"w": jnp.asarray(w0).astype(jdt), "b": [jnp.ones(4, jdt)]}
    tp = {"w": _t(w0).to(tdt), "b": [torch.ones(4, dtype=tdt)]}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(n_steps):
        jg = {"w": (2 * (jp["w"].astype(jnp.float32) - target) * scale
                    ).astype(jdt),
              "b": [(jp["b"][0].astype(jnp.float32) * scale).astype(jdt)]}
        tg = {"w": (2 * (tp["w"].float() - _t(target)) * scale).to(tdt),
              "b": [(tp["b"][0].float() * scale).to(tdt)]}
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    return jp, js, tp, ts


@pytest.mark.parametrize("case", ["plain", "clipped", "decay",
                                  "bf16_moments", "bf16_params"])
def test_adamw_matches_reference_on_a_quadratic(case):
    kw, dtype, scale = {"lr": 0.05, "weight_decay": 0.0}, np.float32, 1.0
    if case == "clipped":                  # every step clipped
        kw, scale = {"lr": 0.05, "grad_clip_norm": 1.0}, 1e3
    if case == "decay":
        kw = {"lr": TS.warmup_cosine(0.1, 3, 30), "weight_decay": 0.1}
    if case == "bf16_moments":
        kw = {"lr": 0.05, "state_dtype": "bfloat16"}
    if case == "bf16_params":
        kw, dtype = {"lr": 0.05, "state_dtype": "bfloat16"}, "bfloat16"
    if case == "decay":
        jkw = {"lr": JS.warmup_cosine(0.1, 3, 30), "weight_decay": 0.1}
        jp, js, tp, ts = _quadratic_pair(20, jkw, kw)
    else:
        jp, js, tp, ts = _quadratic(20, dict(kw), dtype, scale)
    # the same float32 operations in the same order; XLA's fusion and
    # pow may round a last bit differently (1.2e-7 seen over 20 steps), and
    # a last-bit difference can move a bfloat16 rounding by one ulp (2^-8)
    tol = 1e-6 if dtype == np.float32 else 2 ** -8
    for jl, tl in zip(jax.tree.leaves((jp, js.m, js.v)),
                      tree.leaves((tp, ts.m, ts.v))):
        assert str(jl.dtype) == str(tl.dtype).replace("torch.", "")
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
    assert int(ts.step) == int(js.step) == 20


def _quadratic_pair(n_steps, jkw, tkw):
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(6,)).astype(np.float32)
    jopt, topt = JA.AdamW(**jkw), TA.AdamW(**tkw)
    jp, tp = {"w": jnp.asarray(w0)}, {"w": _t(w0)}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(n_steps):
        jp, js = jopt.update({"w": 2 * (jp["w"] - 1.0)}, js, jp)
        tp, ts = topt.update({"w": 2 * (tp["w"] - 1.0)}, ts, tp)
    return jp, js, tp, ts


def test_adamw_converges_and_clips_as_the_reference():
    topt = TA.AdamW(lr=0.1, weight_decay=0.0)
    p = {"w": torch.tensor([5.0, -3.0])}
    s = topt.init(p)
    for _ in range(200):
        p, s = topt.update({"w": 2 * (p["w"] - torch.tensor([1.0, 2.0]))},
                           s, p)
    np.testing.assert_allclose(p["w"].numpy(), [1.0, 2.0], atol=1e-2)
    huge = TA.AdamW(lr=1e-3, grad_clip_norm=1.0)
    z = {"w": torch.zeros(4)}
    new, _ = huge.update({"w": torch.full((4,), 1e6)}, huge.init(z), z)
    assert float(new["w"].abs().max()) < 1.0
    g = {"a": _t(np.arange(6.0, dtype=np.float32)), "b": [torch.ones(3)]}
    assert float(TA.global_norm(g)) == pytest.approx(
        float(JA.global_norm({"a": jnp.arange(6.0), "b": [jnp.ones(3)]})))
    sgd = TA.sgd_update(g, g, 0.5)
    np.testing.assert_array_equal(sgd["a"].numpy(), np.arange(6.0) / 2)


@pytest.mark.parametrize("dtype,state_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.bfloat16)])
def test_donated_update_gives_the_functional_bits(monkeypatch, dtype,
                                                  state_dtype):
    """``update(donate=True)`` writes into the given tensors, slice by slice
    (a slice of 7 elements here, so leaves end mid-slice), and gives the
    functional update's bits; the functional one leaves its inputs as they
    were."""
    monkeypatch.setattr(TA, "DONATE_CHUNK", 7)
    gen = torch.Generator().manual_seed(5)
    opt = TA.AdamW(lr=TS.warmup_cosine(0.05, 2, 10), weight_decay=0.1,
                   grad_clip_norm=0.5, state_dtype=state_dtype)
    p = {"w": torch.randn(5, 6, generator=gen).to(dtype),
         "b": [torch.randn(3, generator=gen).to(dtype)]}
    fp, fs = p, opt.init(p)
    dp, ds = tree.map(torch.clone, p), opt.init(p)
    for _ in range(3):
        g = tree.map(lambda t: torch.randn(t.shape, generator=gen).to(dtype),
                     p)
        before = [t.clone() for t in tree.leaves((fp, fs.m, fs.v))]
        fp, fs = opt.update(g, fs, fp)
        held = tree.leaves((dp, ds.m, ds.v))
        dp, ds = opt.update(g, ds, dp, donate=True)
        assert all(a is b for a, b in zip(tree.leaves((dp, ds.m, ds.v)),
                                          held))
        assert not all(torch.equal(a, b) for a, b in zip(
            before, tree.leaves((fp, fs.m, fs.v))))
        for a, b in zip(tree.leaves((dp, ds.m, ds.v)),
                        tree.leaves((fp, fs.m, fs.v))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(ds.step) == int(fs.step)


def test_warmup_cosine_equals_reference():
    for args in ((1e-3, 100, 1000), (3e-4, 5, 40, 0.2), (1e-2, 0, 10)):
        jf, tf = JS.warmup_cosine(*args), TS.warmup_cosine(*args)
        for step in (0, 1, 3, 5, 50, 99, 100, 101, 500, 999, 1000, 2000):
            want = np.float32(jf(step))
            assert np.float32(tf(step)) == want, (args, step)
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and np.float32(got) == want
    assert float(TS.constant(2e-4)(7)) == float(JS.constant(2e-4)(7))


# -- compression over the reference's stacked leaves ------------------------------

@pytest.fixture(scope="module")
def stacked_grads():
    """Seeded 'gradients' shaped like reduced internlm2's params, in both
    layouts (the reference's stacked tree, the port's per-layer one), with
    a residual from a previous step; values spread over five decades so
    a per-layer scale would differ from the stacked one."""
    cfg = reduced(get_config("internlm2-1.8b"))
    shapes = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def draw(s):
        return (rng.normal(size=s.shape) * 10.0 ** rng.integers(-3, 2, size=s.shape)
                ).astype(np.float32)
    g = jax.tree.map(draw, shapes)
    r = jax.tree.map(lambda s: (rng.normal(size=s.shape) * 1e-3
                                ).astype(np.float32), shapes)
    to_port = lambda t: convert.state_from_jax(  # noqa: E731
        cfg, {"params": t})["params"]
    return cfg, g, r, to_port(g), to_port(r)


def _unstacked(cfg, jtree):
    return convert.state_from_jax(cfg, {"params": jax.tree.map(
        np.asarray, jtree)})["params"]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compression_on_stacked_leaves_matches_reference(stacked_grads,
                                                         scheme):
    cfg, g, r, tg, tr = stacked_grads
    jg = jax.tree.map(jnp.asarray, g)
    jef = JC.ErrorFeedbackState(jax.tree.map(jnp.asarray, r))
    tef = TC.ErrorFeedbackState(tr)
    if scheme == "int8":
        jout, jef2, jwire = JC.compress_int8(jg, jef)
        tout, tef2, twire = TC.compress_int8(tg, tef, cfg=cfg)
    else:
        jout, jef2, jwire = JC.compress_topk(jg, jef, frac=0.05)
        tout, tef2, twire = TC.compress_topk(tg, tef, frac=0.05, cfg=cfg)
    assert twire == int(jwire)
    for want, got in ((jout, tout), (jef2.residual, tef2.residual)):
        want = _unstacked(cfg, want)
        for (pw, lw), (pg, lg) in zip(tree.flatten_with_paths(want),
                                      tree.flatten_with_paths(got)):
            assert pw == pg
            np.testing.assert_array_equal(lg.numpy(), lw.numpy(),
                                          err_msg=f"{scheme} {pw}")
    # per layer (no cfg) is a different computation: the scales differ
    if scheme == "int8":
        per_layer, _, wire = TC.compress_int8(tg, tef)
        n_leaves = len(tree.leaves(tg))
        assert wire == twire + 4 * (n_leaves - len(jax.tree.leaves(jg)))
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree.leaves(per_layer), tree.leaves(tout)))


def test_quantize_int8_matches_reference():
    x = np.random.default_rng(2).normal(size=(7, 9)).astype(np.float32) * 3
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts) == np.float32(js)
    np.testing.assert_array_equal(TC.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=4,
                max_size=64))
@settings(max_examples=25, deadline=None)
def test_int8_error_feedback_preserves_signal(vals):
    """The reference's property (tests/test_substrates.py), on the port."""
    g = {"w": _t(np.array(vals, np.float32))}
    ef = TC.init_error_feedback(g)
    deq1, ef, wire = TC.compress_int8(g, ef)
    deq2, ef, _ = TC.compress_int8(g, ef)
    total = deq1["w"].numpy() + deq2["w"].numpy()
    expect = 2 * np.array(vals, np.float32)
    scale = max(1.0, np.abs(expect).max())
    assert np.abs(total - expect).max() / scale < 0.05
    assert wire < g["w"].numel() * 4


def test_topk_compression_sparsity():
    g = {"w": _t(np.linspace(-1, 1, 100, dtype=np.float32))}
    deq, ef, wire = TC.compress_topk(g, TC.init_error_feedback(g), frac=0.1)
    assert int((deq["w"] != 0).sum()) <= 12 and wire == 10 * 8
    assert float(ef.residual["w"].abs().sum()) > 0
