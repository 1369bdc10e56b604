"""The torch port's DRL selector (paper §3.1.3, §4.3) against the JAX
package on the CPU: the actor-critic forward pass from carried weights,
the trace simulator bit for bit, A3C training steps, ``select``, the
advisor's decision through ``DRLSelector``, and a short Fig. 12 run."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.dsl import reddit_loader as jloader  # noqa: E402
from repro.core.drl import agent as JAg  # noqa: E402
from repro.core.drl import env as JEnv  # noqa: E402
from repro.core.drl import networks as JN  # noqa: E402
from repro_torch.core.drl import agent as TAg  # noqa: E402
from repro_torch.core.drl import env as TEnv  # noqa: E402
from repro_torch.core.drl import networks as TN  # noqa: E402
from repro_torch.core.dsl import reddit_loader as tloader  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: float32 MLPs of 73 → 128 → 64 → 12: the two packages' GEMMs sum in
#: other orders (a few float32 ulps of logits of magnitude ~10)
FWD_TOL = 1e-6


def _sim(pkg):
    queries, cfg = pkg.tpch_like_library()
    return pkg.TraceSimulator(queries, cfg), cfg


def _pair(seed=0):
    """A reference agent and a port agent holding its weights."""
    sim, cfg = _sim(JEnv)
    acfg = dict(state_dim=sim.state_dim, num_actions=cfg.num_candidates,
                seed=seed)
    jagent = JAg.A3CAgent(JAg.A3CConfig(**acfg))
    tagent = TAg.A3CAgent(TAg.A3CConfig(**acfg), device="cpu")
    tagent.net.load_state_dict(TN.params_from_jax(
        jax.tree.map(np.asarray, jagent.params)))
    return jagent, tagent


def _states(n, seed=3):
    sim, _ = _sim(TEnv)
    sim._rng = np.random.default_rng(seed)
    rows = [sim.state_of(sim.sample_workload()) for _ in range(n)]
    return (np.stack([s for s, _ in rows]), np.stack([m for _, m in rows]))


def test_forward_matches_reference_with_carried_weights():
    jagent, tagent = _pair()
    states, masks = _states(32)
    jl = JN.policy_logits(jagent.params, jnp.asarray(states),
                          jnp.asarray(masks))
    jp = JN.policy(jagent.params, jnp.asarray(states), jnp.asarray(masks))
    jv = JN.value(jagent.params, jnp.asarray(states))
    with torch.no_grad():
        s, m = torch.from_numpy(states), torch.from_numpy(masks)
        tl, tv = tagent.net(s, m)
        tp = TN.policy(tagent.net, s, m)
    assert tl.shape == jl.shape and tv.shape == jv.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=FWD_TOL,
                               atol=FWD_TOL)
    # masked slots get probability exactly 0 in both
    assert (tp.numpy()[~masks] == 0).all() and (np.asarray(jp)[~masks]
                                                == 0).all()


def test_init_is_seeded_and_device_independent():
    sim, cfg = _sim(TEnv)
    a = TN.ActorCritic(sim.state_dim, cfg.num_candidates, seed=4)
    b = TN.ActorCritic(sim.state_dim, cfg.num_candidates, seed=4)
    c = TN.ActorCritic(sim.state_dim, cfg.num_candidates, seed=5)
    for (k, x), y, z in zip(a.state_dict().items(),
                            b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(x, y)
        if k.endswith("weight"):
            assert not torch.equal(x, z)
            # N(0, 2/din)
            din = x.shape[1]
            assert abs(float(x.std()) - (2.0 / din) ** 0.5) < 0.25 * (
                2.0 / din) ** 0.5
        else:
            assert not x.any()
    if not torch.cuda.is_available():      # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TAg.A3CAgent(TAg.A3CConfig(state_dim=sim.state_dim,
                                       num_actions=cfg.num_candidates))


def test_simulator_bit_equal_to_reference():
    (jsim, jcfg), (tsim, tcfg) = _sim(JEnv), _sim(TEnv)
    assert tcfg == TEnv.SimConfig(**jcfg.__dict__)
    assert [q.__dict__ for q in tsim.queries] == \
        [q.__dict__ for q in jsim.queries]
    assert tsim.baseline_throughput == jsim.baseline_throughput
    assert tsim.state_dim == jsim.state_dim
    for _ in range(40):
        jw, tw = jsim.sample_workload(), tsim.sample_workload()
        assert [(q.query_id, f) for q, f in tw] == \
            [(q.query_id, f) for q, f in jw]
        (js, jm), (ts, tm) = jsim.state_of(jw), tsim.state_of(tw)
        assert ts.dtype == js.dtype == np.float32
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
        for a in range(tsim.K):
            assert tsim.reward_of(tw, a) == jsim.reward_of(jw, a)
        assert tsim.best_action(tw) == jsim.best_action(jw)
    lib = JEnv.tpch_like_library(num_queries=5, num_keyed=6, seed=2)
    tlib = TEnv.tpch_like_library(num_queries=5, num_keyed=6, seed=2)
    assert [q.__dict__ for q in tlib[0]] == [q.__dict__ for q in lib[0]]


def _batch(n=16, seed=11):
    sim, _ = _sim(TEnv)
    sim._rng = np.random.default_rng(seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(n):
        wl = sim.sample_workload()
        s, m = sim.state_of(wl)
        a = int(rng.choice(np.flatnonzero(m)))
        out.append((s, a, sim.reward_of(wl, a), m))
    return out


def test_train_batch_matches_reference():
    """Three A3C steps from carried weights.  Losses within 1e-5; the
    parameters within 2e-6: AdamW divides m by sqrt(v), so a float32
    difference in a gradient moves its step by the same relative amount
    (lr = 3e-4 times ~1e-6) unless the gradient is itself ~0, where sign
    noise could move it by up to lr; no weight here sits there (the
    masked logits' gradients are exactly 0 in both)."""
    jagent, tagent = _pair()
    for step in range(3):
        rows = _batch(seed=11 + step)
        jl, jaux = jagent.train_batch([JAg.Transition(*r) for r in rows])
        tl, taux = tagent.train_batch([TAg.Transition(*r) for r in rows])
        assert abs(tl - jl) <= 1e-5 * max(1.0, abs(jl)), (step, tl, jl)
        for k in jaux:
            assert abs(taux[k] - jaux[k]) <= 1e-5 * max(1.0, abs(jaux[k]))
    want = TN.params_from_jax(jax.tree.map(np.asarray, jagent.params))
    for k, v in tagent.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    assert int(tagent.opt_state.step) == int(jagent.opt_state.step) == 3


def test_select_equals_reference():
    jagent, tagent = _pair(seed=7)
    states, masks = _states(60, seed=9)
    for s, m in zip(states, masks):
        assert tagent.select(s, m, greedy=True) == \
            jagent.select(s, m, greedy=True)
    # seeded sampling: the same probabilities and the same numpy stream
    draws = [(tagent.select(s, m), jagent.select(s, m))
             for s, m in zip(states, masks)]
    assert [t for t, _ in draws] == [j for _, j in draws]
    assert len({t for t, _ in draws}) > 1
    assert tagent.select(states[0]) == jagent.select(states[0])


def _history(core, loader, sig):
    hist = core.HistoryStore()
    consumer = core.author_integrator()
    for t in range(3):
        hist.log_workload(loader, timestamp=100.0 * t, latency=40.0,
                          input_bytes=2e9)
        hist.log_workload(consumer, timestamp=100.0 * t + 50,
                          latency=120.0, input_bytes=3e9,
                          candidate_stats={sig: {
                              "selectivity": 0.1, "distinct_keys": 1e6,
                              "num_objects": 2e7}})
    return hist


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drl_selector_decision_equals_reference(seed):
    """The reference's ``test_alg3_drl_selector_runs`` case, decided by
    both packages' agents holding the same weights."""
    jagent, tagent = _pair(seed=seed)
    decs = []
    for core, loader_fn, agent in ((jcore, jloader, jagent),
                                   (tcore, tloader, tagent)):
        wl = core.author_integrator()
        c = core.enumerate_candidates(wl.graph, "submissions")[0]
        loader = loader_fn("loader", "raw", "submissions", "json")
        hist = _history(core, loader, c.signature())
        decs.append(core.partitioning_creation(
            loader, "submissions", hist, selector=core.DRLSelector(agent),
            dataset_bytes=2e9, now=400.0))
    jdec, tdec = decs
    np.testing.assert_array_equal(tdec.state, jdec.state)
    assert tdec.action_index == jdec.action_index < len(tdec.features)
    assert tdec.candidate.signature() == jdec.candidate.signature()


def test_short_fig12_run_improves_the_reward():
    """``chip_smoke.py`` phase 12 (a)'s loop, shortened: 20 epochs of 16
    transitions, evaluated on 60 workloads before and after."""
    out = chip_smoke.p12_fig12(np, TEnv, TAg, "cpu", epochs=20, n_eval=60)
    assert out["reward_after"] > out["reward_before"], out
    assert out["losses"][-1] < out["losses"][0]
