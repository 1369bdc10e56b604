"""The runtime modules the port's cluster tier wires up, against the
reference: mesh replanning under node loss/gain (``runtime/elastic``),
p50-window straggler detection (``runtime/straggler``) and the
ClusterHealth control plane over the Coordinator heartbeats
(``runtime/fault_tolerance``, ``cluster/control``).

Each case of ``tests/test_runtime_cluster.py`` runs here once per
package: the same logical clocks and injected latencies go through
``repro`` and ``repro_torch``, every assertion of the reference's case
holds in both, and the port's observable results equal the reference's.
No sleeps, no real nodes.
"""

from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.cluster.control as jcontrol  # noqa: E402
import repro.runtime.elastic as jelastic  # noqa: E402
import repro.runtime.fault_tolerance as jft  # noqa: E402
import repro.runtime.straggler as jstraggler  # noqa: E402
import repro_torch.cluster.control as tcontrol  # noqa: E402
import repro_torch.runtime.elastic as telastic  # noqa: E402
import repro_torch.runtime.fault_tolerance as tft  # noqa: E402
import repro_torch.runtime.straggler as tstraggler  # noqa: E402

REF = SimpleNamespace(elastic=jelastic, ft=jft, straggler=jstraggler,
                      control=jcontrol)
PORT = SimpleNamespace(elastic=telastic, ft=tft, straggler=tstraggler,
                       control=tcontrol)


def _both(case):
    """Run ``case`` against each package; the port's result must equal
    the reference's."""
    want = case(REF)
    got = case(PORT)
    assert got == want
    return got


def _mesh(p):
    return (tuple(p.shape), tuple(p.axes), p.num_devices)


def _signals(sigs):
    return [(s.kind, s.node, s.step, dict(s.detail)) for s in sigs]


# ---------------------------------------------------------------------------
# elastic: mesh replanning
# ---------------------------------------------------------------------------

def test_replan_shrinks_data_axis_to_power_of_two():
    def case(ns):
        cur = ns.elastic.MeshPlan((8, 2), ("data", "model"))
        assert cur.num_devices == 16
        new = ns.elastic.replan_mesh(cur, 12)
        assert new.shape == (4, 2)
        assert new.axes == ("data", "model")
        return _mesh(new)
    _both(case)


def test_replan_grows_back_along_same_path():
    def case(ns):
        cur = ns.elastic.MeshPlan((2, 2), ("data", "model"))
        new = ns.elastic.replan_mesh(cur, 16)
        assert new.shape == (8, 2)
        return _mesh(new)
    _both(case)


def test_replan_exact_fit_and_single_device():
    def case(ns):
        mp = ns.elastic.MeshPlan
        a = ns.elastic.replan_mesh(mp((4, 1), ("data", "model")), 4)
        b = ns.elastic.replan_mesh(mp((4, 1), ("data", "model")), 1)
        assert a.shape == (4, 1) and b.shape == (1, 1)
        return _mesh(a), _mesh(b)
    _both(case)


def test_replan_fewer_devices_than_model_axis_raises():
    def case(ns):
        cur = ns.elastic.MeshPlan((2, 4), ("data", "model"))
        with pytest.raises(ValueError, match="fewer surviving devices") as e:
            ns.elastic.replan_mesh(cur, 3)
        return str(e.value)
    _both(case)


def test_replan_collapses_degraded_pod_axis():
    def case(ns):
        cur = ns.elastic.MeshPlan((2, 4, 2), ("pod", "data", "model"))
        new = ns.elastic.replan_mesh(cur, 8)
        assert new.shape == (1, 4, 2)
        assert new.axes == ("pod", "data", "model")
        return _mesh(new)
    _both(case)


def test_resharding_plan_covers_every_row_once():
    def case(ns):
        old = ns.elastic.MeshPlan((4, 1), ("data", "model"))
        new = ns.elastic.replan_mesh(old, 2)
        plan = ns.elastic.resharding_plan(old, new, batch_dim=64)
        assert plan["per_device_batch"] == 32
        rows = []
        for a in plan["assignments"]:
            lo, hi = a["rows"]
            rows.extend(range(lo, hi))
            assert a["reads_old_shards"] == sorted(
                {r // (64 // 4) for r in range(lo, hi)})
        assert rows == list(range(64))
        return (_mesh(plan["old"]), _mesh(plan["new"]),
                plan["per_device_batch"], plan["assignments"])
    _both(case)


# ---------------------------------------------------------------------------
# straggler: deterministic p50-window detection
# ---------------------------------------------------------------------------

def test_threshold_needs_min_samples():
    def case(ns):
        mit = ns.straggler.StragglerMitigator(
            ns.straggler.StragglerConfig(min_samples=4))
        seen = []
        for _ in range(3):
            mit.record(0.01)
            seen.append(mit.threshold())
        assert mit.threshold() is None
        mit.record(0.01)
        assert mit.threshold() == pytest.approx(0.02)
        return seen, mit.threshold()
    _both(case)


def test_fetch_shard_reissues_on_injected_latency():
    def case(ns):
        mit = ns.straggler.StragglerMitigator(
            ns.straggler.StragglerConfig(min_samples=4, factor=2.0))
        calls = []

        def fetch(step, host):
            calls.append((step, host))
            return {"host": host}

        for step in range(4):
            mit.fetch_shard(fetch, step, host=0, backup_host=1,
                            simulated_latency=0.01)
        assert mit.reissues == 0
        shard = mit.fetch_shard(fetch, 4, host=0, backup_host=1,
                                simulated_latency=1.0)
        assert shard == {"host": 0}
        assert mit.reissues == 1
        assert calls.count((4, 0)) == 2
        assert mit.detections[-1] == (4, 0, 1.0)
        return calls, mit.reissues, list(mit.detections), list(mit.samples)
    _both(case)


def test_window_slides_so_old_slowness_ages_out():
    def case(ns):
        mit = ns.straggler.StragglerMitigator(
            ns.straggler.StragglerConfig(window=8, min_samples=4))
        for _ in range(8):
            mit.record(1.0)
        slow = mit.threshold()
        assert slow == pytest.approx(2.0)
        for _ in range(8):
            mit.record(0.01)
        assert mit.threshold() == pytest.approx(0.02)
        return slow, mit.threshold()
    _both(case)


# ---------------------------------------------------------------------------
# ClusterHealth: heartbeats → node_lost, reads → straggler signals
# ---------------------------------------------------------------------------

def test_health_declares_silent_node_lost_once():
    def case(ns):
        h = ns.control.ClusterHealth(("a", "b"), miss_threshold=3)
        sigs = []
        for step in range(1, 6):
            h.heartbeat("a", step)
            sigs += h.tick(step)
        assert [s.kind for s in sigs] == ["node_lost"]
        assert sigs[0].node == "b" and sigs[0].step == 3
        assert h.alive_nodes() == ["a"] and h.dead_nodes() == ["b"]
        assert h.heartbeat_misses >= 3
        assert h.tick(6) == [] and h.signals() == [sigs[0]]
        misses = h.heartbeat_misses
        h.reset_nodes(("a",))
        for step in range(1, 5):
            h.heartbeat("a", step)
            assert h.tick(step) == []
        assert h.dead_nodes() == []
        return _signals(sigs), misses, h.heartbeat_misses, h.nodes
    _both(case)


def test_health_heartbeat_keeps_node_alive():
    def case(ns):
        h = ns.control.ClusterHealth(("a", "b"), miss_threshold=2)
        for step in range(1, 10):
            h.heartbeat("a", step)
            h.heartbeat("b", step)
            assert h.tick(step) == []
        assert h.dead_nodes() == []
        h.heartbeat("nonexistent", 99)
        return h.alive_nodes(), h.heartbeat_misses
    _both(case)


def test_health_straggler_signal_after_repeated_detections():
    def case(ns):
        detections = ns.control.STRAGGLER_SIGNAL_DETECTIONS
        cfg = ns.straggler.StragglerConfig(min_samples=4, factor=2.0)
        h = ns.control.ClusterHealth(("a", "b", "c"), straggler=cfg)
        for _ in range(4):
            for n in ("a", "b", "c"):
                assert h.record_read(n, 0.01) is False
        sigs = []
        for _ in range(detections):
            assert h.record_read("b", 1.0) is True
            sigs += h.signals()
        assert h.straggler_reissues == detections
        assert [s.kind for s in sigs] == ["straggler"]
        assert sigs[0].node == "b"
        assert sigs[0].detail["latency_s"] == pytest.approx(1.0)
        assert sigs[0].detail["detections"] == detections
        assert h.straggler_excess_s("b") > 0.3
        assert h.straggler_excess_s("a") == pytest.approx(0.0, abs=1e-6)
        return (_signals(sigs), h.straggler_reissues,
                h.straggler_excess_s("b"), h.straggler_excess_s("a"))
    _both(case)


def test_health_latency_injector_overrides_measured():
    def case(ns):
        h = ns.control.ClusterHealth(("a",))
        h.set_read_latency(lambda node: 0.25)
        out = [h.observed_latency("a", 99.0)]
        h.set_read_latency(lambda node: None)
        out.append(h.observed_latency("a", 0.5))
        h.set_read_latency(None)
        out.append(h.observed_latency("a", 0.75))
        assert out == [0.25, 0.5, 0.75]
        return out
    _both(case)


def test_coordinator_backoff_and_state_machine():
    def case(ns):
        c = ns.ft.Coordinator(2, miss_threshold=1, max_restarts=1)
        states = [c.state.value]
        ev = c.tick(1, checkpoint_step=0)
        assert ev is not None and c.state == ns.ft.RunState.RECOVERING
        assert c.backoff_s() == pytest.approx(0.1)
        states.append(c.state.value)
        c.recover()
        assert c.state == ns.ft.RunState.RUNNING
        ev2 = c.tick(2, checkpoint_step=1)
        assert ev2 is not None and ev2.restart_step == 1
        assert c.state == ns.ft.RunState.FAILED
        assert c.backoff_s() == pytest.approx(0.2)
        states.append(c.state.value)
        return (states, [(e.step, e.worker, e.restart_step)
                         for e in c.events], c.backoff_s(),
                c.alive_workers())
    _both(case)
