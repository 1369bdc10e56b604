"""The torch port's MoE layer (``models/moe.py``) against the JAX package.

Seeded numpy inputs and JAX-initialised weights go to both packages.  The
routing — each (token, slot)'s expert, its slot in the expert's queue and
whether it is kept — must equal the reference's exactly; it is read from
the reference's ``_local_dispatch``, the routing code its single-device
``moe_ffn`` repeats.  Outputs and both aux terms are held within 1e-4 in
float32, and so are ``loss_fn`` and its gradient for the two MoE configs
at ``reduced()`` size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.reduced import reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _layer(E, k, shared, D=32, F=24, seed=0):
    p = JM.moe_init(jax.random.PRNGKey(seed), D, F, E, shared, jnp.float32)
    return p, TR.map(convert.to_torch, _np(p))


@pytest.mark.parametrize("tokens,E,k,factor", [
    (24, 8, 2, 1.25), (1, 8, 2, 1.25), (7, 160, 6, 1.25),
    (32768, 160, 6, 1.25), (32768, 128, 1, 1.25), (1024, 128, 1, 128.0),
    (8, 128, 1, 1.25), (100, 4, 3, 0.5)])
def test_capacity_matches_reference(tokens, E, k, factor):
    assert TM.capacity(tokens, E, k, factor) == JM.capacity(tokens, E, k,
                                                            factor)


# (E, top_k, shared, capacity_factor, activation, B, S): top-2 with a shared
# expert, drops at a small factor, deepseek's top-6 with 2 shared, llama4's
# top-1, and a factor of E / k where nothing can drop
MOE_CASES = [
    (8, 2, 1, 1.25, "silu", 2, 12),
    (8, 2, 0, 0.5, "silu", 2, 12),
    (16, 6, 2, 1.25, "silu", 2, 10),
    (16, 6, 2, 0.3, "gelu", 3, 7),
    (8, 1, 1, 1.25, "silu", 2, 16),
    (8, 1, 1, 8.0, "gelu", 1, 9),
]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_matches_reference(case):
    E, k, shared, factor, act, B, S = case
    jp, tp = _layer(E, k, shared, seed=E + k)
    x = np.random.default_rng(E * k + S).standard_normal(
        (B, S, 32)).astype(np.float32)
    T = B * S
    C = JM.capacity(T, E, k, factor)

    # routing, exactly
    xt = x.reshape(T, 32)
    logits = JL.dense(jp["router"], jnp.asarray(xt))
    jbuf, (e_flat, p_flat, k_flat, _, _, _) = JM._local_dispatch(
        jnp.asarray(xt), logits, E, k, C, jnp.float32)
    r = TM.route(tp, torch.from_numpy(xt), E, k, C)
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(e_flat))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(k_flat))
    np.testing.assert_array_equal(torch.where(r.keep, r.pos, C - 1).numpy(),
                                  np.asarray(p_flat))
    assert bool((r.pos[~r.keep] >= C).all())
    if factor < 1:
        assert not bool(r.keep.all())           # the drop case drops

    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), num_experts=E, top_k=k,
                          capacity_factor=factor, activation=act)
    ty, taux = TM.moe_ffn(tp, torch.from_numpy(x), num_experts=E, top_k=k,
                          capacity_factor=factor, activation=act)
    assert tuple(ty.shape) == (B, S, 32)
    _close(ty.numpy(), jy, "moe output")
    for key in ("load_balance_loss", "dropped_frac"):
        _close(taux[key].numpy(), jaux[key], key)


def test_routing_ties_take_the_lower_expert():
    """A zero router gives every expert the same probability, and two equal
    router columns tie two experts: top-k takes the lower indices first,
    jax.lax.top_k's rule."""
    E, k, T = 8, 3, 6
    jp, tp = _layer(E, k, 0, seed=1)
    xt = np.random.default_rng(2).standard_normal((T, 32)).astype(np.float32)
    w = np.asarray(jp["router"]["w"])
    for router in (np.zeros_like(w), w[:, [0, 1, 5, 3, 4, 5, 6, 5]]):
        jr = {"w": jnp.asarray(router)}
        logits = JL.dense(jr, jnp.asarray(xt))
        _, (e_flat, p_flat, _, _, _, _) = JM._local_dispatch(
            jnp.asarray(xt), logits, E, k, 8, jnp.float32)
        r = TM.route({"router": {"w": torch.from_numpy(router)}},
                     torch.from_numpy(xt), E, k, 8)
        np.testing.assert_array_equal(r.expert.numpy(), np.asarray(e_flat))
        np.testing.assert_array_equal(torch.where(r.keep, r.pos, 7).numpy(),
                                      np.asarray(p_flat))
        rows = r.expert.reshape(T, k).tolist()
        if not router.any():
            assert rows == [[0, 1, 2]] * T
        else:       # experts 2, 5 and 7 tie: whichever of them are picked
            for row in rows:    # come in index order
                tied = [e for e in row if e in (2, 5, 7)]
                assert tied == sorted(tied)


def test_router_stays_float32_in_a_bf16_model():
    cfg = dataclasses.replace(reduced(get_config("llama4-maverick-400b-a17b")),
                              param_dtype="bfloat16")
    params = convert.params_from_jax(
        cfg, _np(JT.init_params(cfg, jax.random.PRNGKey(0))))
    mine = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for tree in (params, mine):
        moe = [lay["ffn"] for lay in tree["layers"] if "router" in lay["ffn"]]
        assert len(moe) == sum(s.ffn == "moe" for s in cfg.all_specs) == 4
        for f in moe:
            assert f["router"]["w"].dtype == torch.float32
            assert f["w_in"].dtype == torch.bfloat16
            assert tuple(f["w_in"].shape) == (8, 64, 64)


def test_expert_init_has_the_reference_scale():
    """Experts are drawn one at a time (a float32 draw of a whole stack of
    llama4-maverick's would be 21.5 GB); each slice keeps the reference's
    1/sqrt(fan_in) scale."""
    p = TM.moe_init(torch.Generator().manual_seed(0), 256, 512, 4, 1,
                    torch.float32)
    for name, fan_in in (("w_in", 256), ("w_gate", 256), ("w_out", 512)):
        std = p[name].std(dim=(1, 2))
        assert torch.allclose(std, torch.full((4,), fan_in ** -0.5),
                              rtol=0.02), name
    assert not torch.equal(p["w_in"][0], p["w_in"][1])
    assert tuple(p["shared"]["w_in"]["w"].shape) == (256, 512)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
def test_loss_and_gradient_match_reference(arch):
    """``loss_fn`` = ce + aux_loss_coef × the summed load-balance loss, and
    its gradient on every leaf, against ``jax.value_and_grad`` of the
    reference's."""
    cfg = reduced(get_config(arch))
    params = JT.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    (jloss, jmet), jgrad = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels)}),
        has_aux=True)(params)
    assert float(jmet["moe_aux"]) > 0

    tparams = convert.params_from_jax(cfg, _np(params))
    leaves = [t.requires_grad_(True) for t in TR.leaves(tparams)]
    tloss, tmet = TT.loss_fn(cfg, TR.unflatten(tparams, leaves),
                             {"tokens": torch.from_numpy(tokens),
                              "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(tloss, leaves)
    _close(tloss.detach().numpy(), jloss, "loss")
    for key in ("ce", "moe_aux"):
        _close(tmet[key].detach().numpy(), jmet[key], key)
    ce, aux = (float(tmet[k].detach()) for k in ("ce", "moe_aux"))
    assert float(tloss.detach()) == pytest.approx(
        ce + cfg.moe.aux_loss_coef * aux)
    stacked = convert.stack_params(cfg, TR.unflatten(tparams, list(grads)))
    want = dict(TR.flatten_with_paths(_np(jgrad)))
    got = dict(TR.flatten_with_paths(stacked))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        _close(g.numpy(), want[path], f"grad {path}", tol=2e-4)


def test_stacked_layout_round_trips_the_moe_leaves():
    """The (E, D, F) experts, the float32 router and the shared expert
    stack into the reference's ``blocks/s{s}`` layout and back."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    params = _np(JT.init_params(cfg, jax.random.PRNGKey(5)))
    tparams = convert.params_from_jax(cfg, params)
    stacked = convert.stack_params(cfg, tparams)
    want = dict(TR.flatten_with_paths(params))
    got = dict(TR.flatten_with_paths(stacked))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.dtype == convert.to_torch(want[path]).dtype, path
        np.testing.assert_array_equal(g.numpy(), want[path], err_msg=path)
    back = convert.unstack_params(cfg, stacked)
    for a, b in zip(TR.leaves(back), TR.leaves(tparams)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
def test_phase13_decode_check_dry_run(arch):
    """``chip_smoke.py`` phase 13's decode-against-prefill check on the CPU
    at ``reduced()`` size in float32: at a capacity factor of E / top_k no
    prefill drops a token and decode matches prefill within 1e-3 of the
    logits' max-abs; a prefill reports one drop fraction per MoE layer."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    cfg = reduced(get_config(arch))
    tparams = convert.params_from_jax(
        cfg, _np(JT.init_params(cfg, jax.random.PRNGKey(6))))
    chip_smoke.p13_decode_check(torch, np, TT, cfg, tparams, (2, 16, 8),
                                "float32")
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        _, _, aux = TT.prefill(cfg, tparams, tokens, with_aux=True)
    assert len(aux["dropped_frac"]) == sum(s.ffn == "moe"
                                           for s in cfg.all_specs)
    assert all(0 <= float(d) < 1 for d in aux["dropped_frac"])
