"""A stored dataset on a mesh of several devices in the torch port
(``core/sharding_bridge.py``'s ``ShardedColumn`` and ``device_put_dataset``,
``data/device_repartition.sharded_repartition_dataset``, and the store,
``Session``, ``apply_decision`` and the Autopilot passing a mesh), against
the JAX package on four host devices.

One driver, :func:`run_cases`, runs every case through either package's
entry points: the reference in a subprocess with
``--xla_force_host_platform_device_count=4`` (its meshes over four CPU
devices), the port in this process on ``Mesh(["cpu"] * 4, ...)``.  The
inputs are seeded numpy, the same for both.  Each case records, per column,
the spec, every shard's mesh position, leading-axis slice and bits, and the
whole column's bits; the port must equal the reference in all of them.  The
reference keeps 64-bit columns on the host (no x64), so for those the
port's shards are held to the matching rows of the reference's values.

The Autopilot case fixes both packages' calibration as
``tests/test_torch_service.py``'s ``pinned`` fixture does.  The persist
case compares segment files by sha256.  The port also reports its
whole-column reads (``sharding_bridge.WHOLE_READS``) after each
repartition: none on the uniform shard-to-shard path.
"""

import hashlib
import os
import pickle
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = Path(__file__).resolve().parents[1]
M = 8
#: mesh name → (device grid shape, axis names, data axes)
MESHES = {"4": ((4,), ("data",), ("data",)),
          "2x2": ((2, 2), ("data", "model"), ("data",)),
          "pod": ((2, 2, 1), ("pod", "data", "model"), ("pod", "data"))}
ORDERKEY_SIG = "scan/attr:orderkey/partition[hash]"
PARTKEY_SIG = "scan/attr:partkey/partition[hash]"


def _host_pids(keys, m=M):
    from repro_torch.data import device_repartition as tdr
    return tdr.shuffle_pids(np.asarray(keys), m, mode="hostperm",
                            device="cpu")[0]


def _keys_in(rng, n, hi, workers):
    """``n`` keys below ``hi`` whose hash partition over ``M`` is one of
    ``workers``."""
    pool = rng.integers(0, hi, 8 * n)
    return pool[np.isin(_host_pids(pool), workers)][:n]


def lineitem(n=600, seed=0, case="uniform"):
    """Seeded lineitem rows with a column of every dtype the store holds.
    ``zipf`` skews partkey (an adaptive store buckets it); ``holes`` keys
    orderkey onto workers 0-5 only (the mesh's last shard holds no rows)
    and partkey onto workers 0-3 (its last two destination blocks get
    none)."""
    rng = np.random.default_rng(seed)
    ok = rng.integers(0, 150, n)
    pk = rng.integers(0, 100, n)
    if case == "zipf":
        pk = np.minimum(rng.zipf(1.3, n), 10_000) - 1
    if case == "holes":
        ok = _keys_in(rng, n, 150, range(6))
        pk = _keys_in(rng, n, 100, range(4))
    if case == "empty":
        n = 0
        ok, pk = ok[:0], pk[:0]
    return {"orderkey": ok.astype(np.int64), "partkey": pk.astype(np.int64),
            "qty": rng.integers(1, 50, n).astype(np.int32),
            "price": rng.normal(100, 20, n).astype(np.float32),
            "tax": rng.random(n).astype(np.float64),
            "flag": rng.random(n) < 0.5,
            "vec": rng.normal(size=(n, 3)).astype(np.float32)}


def _cands(core):
    wl = core.Workload("mesh")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    return core.enumerate_candidates(wl.graph, "lineitem")


def _cand_by_sig(core, wl, table, sig):
    return next(c for c in core.enumerate_candidates(wl.graph, table)
                if c.signature() == sig)


def pin_calibration(setattr_, svc, core):
    """``test_torch_service.pinned``: no live throughput samples, and a
    1 s latency on every logged run."""
    def drop(self, nbytes, seconds):
        return None

    for name in ("observe_shuffle", "observe_repartition", "observe_io"):
        setattr_(svc.WhatIfCostModel, name, drop)
    orig = core.HistoryStore.log_workload

    def log_workload(self, workload, **kw):
        kw["latency"] = 1.0
        return orig(self, workload, **kw)
    setattr_(core.HistoryStore, "log_workload", log_workload)


# -- the two packages behind one interface ---------------------------------

class JaxEnv:
    """The reference on four host devices (run in the subprocess)."""

    def __init__(self):
        import jax
        import lachesis
        import repro.core as core
        import repro.service as svc
        from repro.core.sharding_bridge import device_put_dataset
        from repro.data.partition_store import PartitionStore
        from repro.service import drivers
        self.jax, self.core, self.svc, self.drivers = jax, core, svc, drivers
        self.put = device_put_dataset
        self._store, self._session = PartitionStore, lachesis.Session
        self._devs = np.array(jax.devices()[:4])

    def mesh(self, name):
        from jax.sharding import Mesh
        shape, axes, _ = MESHES[name]
        return Mesh(self._devs.reshape(shape), axes)

    def store(self, **kw):
        return self._store(M, backend="device", **kw)

    def session(self, store):
        return self._session(store, backend="device")

    def reopen(self, root):
        return self._store.open(root, backend="device")

    def column(self, v, mesh):
        if not isinstance(v, self.jax.Array):
            return {"spec": None, "shards": None, "values": np.asarray(v)}
        pos = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
        spec = getattr(v.sharding, "spec", ())
        shards = sorted((pos[s.device.id], s.index[0].start or 0,
                         s.index[0].stop if s.index[0].stop is not None
                         else v.shape[0], np.asarray(s.data))
                        for s in v.addressable_shards)
        return {"spec": tuple(spec), "shards": shards,
                "values": np.asarray(v)}

    def placed(self, v) -> bool:
        return isinstance(v, self.jax.Array) and len(v.sharding.device_set) > 1

    def reads(self) -> int:
        return 0


class TorchEnv:
    """The port on ``Mesh(["cpu"] * 4, ...)``."""

    def __init__(self):
        import lachesis_torch
        import repro_torch.core as core
        import repro_torch.service as svc
        from repro_torch.core import sharding_bridge as sb
        from repro_torch.data.partition_store import PartitionStore
        from repro_torch.service import drivers
        self.core, self.svc, self.drivers, self.sb = core, svc, drivers, sb
        self.put = sb.device_put_dataset
        self._store, self._session = PartitionStore, lachesis_torch.Session

    def mesh(self, name):
        shape, axes, _ = MESHES[name]
        return self.sb.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(
            shape), axes)

    def store(self, **kw):
        return self._store(M, backend="device", device="cpu", **kw)

    def session(self, store):
        return self._session(store, backend="device", device="cpu")

    def reopen(self, root):
        return self._store.open(root, backend="device", device="cpu")

    def column(self, v, mesh):
        if not isinstance(v, self.sb.ShardedColumn):
            return {"spec": "unplaced", "shards": None,
                    "values": np.asarray(v)}
        shards = sorted((idx, sl.start, sl.stop, t.numpy())
                        for idx, _, sl, t in v.shards())
        return {"spec": tuple(v.sharding.spec), "shards": shards,
                "values": np.asarray(v)}

    def placed(self, v) -> bool:
        return isinstance(v, self.sb.ShardedColumn) and len(
            list(v.shards())) > 1

    def reads(self) -> int:
        return self.sb.WHOLE_READS["columns"]


def _layout(env, ds, mesh):
    cm = ds.capacity_map
    return {"counts": np.asarray(ds.counts), "generation": ds.generation,
            "partitioner": ds.partitioner.signature()
            if ds.partitioner else None,
            "capacities": None if cm is None else np.asarray(cm.capacities),
            "columns": {k: env.column(v, mesh)
                        for k, v in sorted(ds.columns.items())}}


def _repartition_case(env, case, mesh_name, tmp=None):
    """Write lineitem by orderkey, place it on the mesh, repartition it by
    partkey with ``mesh=``; the layout, the path and the port's
    whole-column reads."""
    mesh = env.mesh(mesh_name)
    kw = {"adaptive_capacity": True} if case.startswith("zipf") else {}
    if tmp is not None:
        kw["root"] = tmp
    store = env.store(**kw)
    by_order, by_part = _cands(env.core)
    data = lineitem(case="zipf" if case.startswith("zipf") else case)
    if case == "zipf_source":
        data["orderkey"], data["partkey"] = data["partkey"], \
            data["orderkey"]
    ds = store.write("lineitem", data, by_order)
    placed = env.put(mesh, ds, MESHES[mesh_name][2])
    r0 = env.reads()
    new, moved = store.repartition(placed, by_part, mesh=mesh)
    out = {"reads": env.reads() - r0, "moved": moved,
           "path": store.write_log[-1].get("path", "host"),
           "source": _layout(env, placed, mesh),
           "layout": _layout(env, new, mesh),
           "served": store.read(new.name) is new}
    if tmp is not None:
        files = {}
        for dirpath, _, names in os.walk(tmp):
            for f in names:
                if f.endswith(".seg"):
                    p = os.path.join(dirpath, f)
                    files[os.path.relpath(p, tmp)] = hashlib.sha256(
                        Path(p).read_bytes()).hexdigest()
        out["segments"] = files
        back = env.reopen(tmp).read(new.name)
        out["reopened"] = {k: env.placed(v) for k, v in back.columns.items()}
        out["reopened_values"] = {k: np.asarray(v)
                                  for k, v in back.columns.items()}
    return out


def _session_case(env):
    """``Session.repartition(mesh=)`` twice (placing, then shard to shard),
    ``apply_decision(mesh=)`` back to orderkey, ``gather()`` and a run of
    the q_orderkey consumer over the placed lineitem."""
    mesh = env.mesh("4")
    tables = env.drivers.drift_tables(n_lineitem=2000, n_orders=400,
                                      n_parts=120, seed=1)
    store = env.store()
    for name, data in tables.items():
        store.write(name, data)
    sess = env.session(store)
    wl = env.drivers.q_orderkey()
    by_order = _cand_by_sig(env.core, wl, "lineitem", ORDERKEY_SIG)
    by_part = _cand_by_sig(env.core, env.drivers.q_partkey(), "lineitem",
                           PARTKEY_SIG)
    first, m1 = sess.repartition("lineitem", by_order, mesh=mesh)
    second, m2 = sess.repartition("lineitem", by_part, mesh=mesh)
    dec = env.core.PartitioningDecision(
        dataset="lineitem", candidate=by_order, features=[], consumers=[],
        action_index=0, state=None, elapsed_s=0.0)
    applied, m3 = env.core.apply_decision(store, dec, mesh=mesh)
    vals, stats = sess.run(wl)
    return {"layouts": [_layout(env, d, mesh)
                        for d in (first, second, applied)],
            "moved": [m1, m2, m3],
            "served": store.read("lineitem") is applied,
            "gather": applied.gather(),
            "result": env.drivers.aggregate_result(vals, wl),
            "elided": stats.shuffles_elided,
            "performed": stats.shuffles_performed}


def _autopilot_case(env):
    """lineitem placed on the mesh by partkey; three runs of the orderkey
    consumer; one tick applies lineitem's (shard to shard) and orders'
    repartitions onto the mesh."""
    mesh = env.mesh("4")
    tables = env.drivers.drift_tables(n_lineitem=3000, n_orders=600,
                                      n_parts=150, seed=0)
    store = env.store()
    for name, data in tables.items():
        store.write(name, data)
    sess = env.session(store)
    by_part = _cand_by_sig(env.core, env.drivers.q_partkey(), "lineitem",
                           PARTKEY_SIG)
    sess.repartition("lineitem", by_part, mesh=mesh)
    ap = sess.autopilot(clock=env.svc.LogicalClock(),
                        config=env.drivers.default_drift_config(), mesh=mesh)
    wl = env.drivers.q_orderkey()
    for _ in range(3):
        sess.run(wl)
    rep = ap.tick()
    vals, stats = sess.run(wl)
    return {"applied": [(a.dataset, a.kind, a.path, int(a.generation),
                         int(a.moved_bytes),
                         a.decision.candidate.signature()) for a in
                        rep.applied],
            "considered": [(d, sig) for d, sig, _ in rep.considered],
            "why": rep.why,
            "layouts": {n: _layout(env, store.read(n), mesh)
                        for n in ("lineitem", "orders")},
            "result": env.drivers.aggregate_result(vals, wl),
            "elided": stats.shuffles_elided}


REPARTITIONS = [("uniform", "4"), ("uniform", "2x2"), ("uniform", "pod"),
                ("zipf", "4"), ("zipf_source", "4"), ("empty", "4"),
                ("holes", "4")]


def run_cases(env, tmp):
    """Every case through ``env``'s package; ``tmp``: a fresh directory
    for the durable store."""
    out = {"placement": {}, "repartition": {}}
    store = env.store()
    by_order, _ = _cands(env.core)
    ds = store.write("lineitem", lineitem(), by_order)
    for name in MESHES:
        mesh = env.mesh(name)
        out["placement"][name] = _layout(
            env, env.put(mesh, ds, MESHES[name][2]), mesh)
    for case, mesh_name in REPARTITIONS:
        out["repartition"][case, mesh_name] = _repartition_case(
            env, case, mesh_name)
    out["persist"] = _repartition_case(env, "uniform", "4",
                                       os.path.join(tmp, "durable"))
    out["session"] = _session_case(env)
    out["autopilot"] = _autopilot_case(env)
    return out


REFERENCE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import test_torch_mesh_store as t
    env = t.JaxEnv()
    assert len(env.jax.devices()) == 4
    t.pin_calibration(setattr, env.svc, env.core)
    out = t.run_cases(env, sys.argv[2])
    with open(os.path.join(sys.argv[2], "ref.pkl"), "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    env_vars = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(Path(__file__).parent),
         str(ref_dir)], env=env_vars, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    with pytest.MonkeyPatch.context() as mp:
        env = TorchEnv()
        pin_calibration(mp.setattr, env.svc, env.core)
        got = run_cases(env, str(port_dir))
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    with open(ref_dir / "ref.pkl", "rb") as f:      # written just above
        want = pickle.load(f)
    return got, want


def _same_column(got, want, what):
    np.testing.assert_array_equal(got["values"], want["values"],
                                  err_msg=what)
    assert got["values"].dtype == want["values"].dtype, what
    if want["shards"] is None:
        # a 64-bit column the reference keeps on the host: the port's
        # shards hold its rows
        for _, a, b, data in got["shards"]:
            np.testing.assert_array_equal(data, want["values"][a:b],
                                          err_msg=what)
        return
    assert got["spec"] == want["spec"], what
    assert [s[:3] for s in got["shards"]] == [s[:3] for s in want["shards"]]
    for g, w in zip(got["shards"], want["shards"]):
        np.testing.assert_array_equal(g[3], w[3], err_msg=f"{what} {g[:3]}")


def _same_layout(got, want, what):
    for k in ("counts", "capacities"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=what)
    assert got["generation"] == want["generation"], what
    assert got["partitioner"] == want["partitioner"], what
    assert set(got["columns"]) == set(want["columns"]), what
    specs = {c["spec"] for c in want["columns"].values()
             if c["spec"] is not None}
    for k, w in want["columns"].items():
        g = got["columns"][k]
        _same_column(g, w, f"{what} {k}")
        if w["spec"] is None:      # spec of the reference's other columns
            assert g["spec"][:1] in {s[:1] for s in specs}, (what, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_device_put_dataset_matches_reference_shard_by_shard(results, mesh):
    got, want = results
    _same_layout(got["placement"][mesh], want["placement"][mesh],
                 f"placement on {mesh}")
    shards = got["placement"][mesh]["columns"]["price"]["shards"]
    blocks = Counter((a, b) for _, a, b, _ in shards)
    extent = int(np.prod([dict(zip(MESHES[mesh][1], MESHES[mesh][0]))[a]
                          for a in MESHES[mesh][2]]))
    assert len(shards) == 4 and len(blocks) == extent


@pytest.mark.parametrize("case,mesh", REPARTITIONS,
                         ids=[f"{c}-{m}" for c, m in REPARTITIONS])
def test_repartition_onto_mesh_matches_reference(results, case, mesh):
    got, want = results
    g, w = got["repartition"][case, mesh], want["repartition"][case, mesh]
    assert (g["moved"], g["path"], g["served"]) == \
        (w["moved"], w["path"], w["served"]) == (w["moved"], "d2d", True)
    _same_layout(g["source"], w["source"], f"{case} on {mesh}: source")
    _same_layout(g["layout"], w["layout"], f"{case} on {mesh}")
    bucketed = g["layout"]["capacities"] is not None
    assert bucketed == (case == "zipf")
    # the uniform path goes shard to shard; a bucketed result is flattened
    # onto the mesh's first device, one read per column
    assert g["reads"] == (len(g["layout"]["columns"]) if bucketed else 0)


def test_empty_and_holed_shards(results):
    got, _ = results
    holes = got["repartition"]["holes", "4"]
    src = holes["source"]["counts"]
    assert src[6:].sum() == 0 and src[:6].all()
    dst = holes["layout"]["counts"]
    assert dst[4:].sum() == 0 and dst[:4].all()
    empty = got["repartition"]["empty", "4"]["layout"]
    assert empty["counts"].sum() == 0
    assert empty["columns"]["price"]["values"].shape == (M, 1)


def test_persist_of_a_placed_dataset_matches_reference(results):
    got, want = results
    g, w = got["persist"], want["persist"]
    assert g["segments"] and g["segments"] == w["segments"]
    _same_layout(g["layout"], w["layout"], "persisted")
    assert not any(g["reopened"].values()) and not any(
        w["reopened"].values())
    for k, v in w["reopened_values"].items():
        np.testing.assert_array_equal(g["reopened_values"][k], v)


def test_session_and_apply_decision_onto_mesh_match_reference(results):
    got, want = results
    g, w = got["session"], want["session"]
    assert g["moved"] == w["moved"] and g["served"] and w["served"]
    for i, (a, b) in enumerate(zip(g["layouts"], w["layouts"])):
        _same_layout(a, b, f"session step {i}")
    for k, v in w["gather"].items():
        assert g["gather"][k].dtype == v.dtype
        np.testing.assert_array_equal(g["gather"][k], v, err_msg=k)
    for k, v in w["result"].items():
        np.testing.assert_array_equal(g["result"][k], v, err_msg=k)
    assert (g["elided"], g["performed"]) == (w["elided"], w["performed"])


def test_autopilot_tick_onto_mesh_matches_reference(results):
    got, want = results
    g, w = got["autopilot"], want["autopilot"]
    assert g["applied"] == w["applied"]
    assert {a[0] for a in g["applied"]} == {"lineitem", "orders"}
    assert {a[2] for a in g["applied"]} == {"d2d"}
    assert g["considered"] == w["considered"] and g["why"] == w["why"]
    for n in ("lineitem", "orders"):
        _same_layout(g["layouts"][n], w["layouts"][n], f"autopilot {n}")
    for k, v in w["result"].items():
        np.testing.assert_array_equal(g["result"][k], v, err_msg=k)
    assert g["elided"] == w["elided"]


def test_whole_reads_are_counted():
    """The counter moves on a whole-column read, a gather and a flatten
    onto one device, and not on placement or the shard-to-shard path."""
    env = TorchEnv()
    sb = env.sb
    store = env.store()
    by_order, by_part = _cands(env.core)
    ds = store.write("lineitem", lineitem(), by_order)
    mesh = env.mesh("4")
    sb.reset_whole_reads()
    placed = env.put(mesh, ds)
    new, _ = store.repartition(placed, by_part, mesh=mesh)
    assert sb.WHOLE_READS["columns"] == 0
    col = new.columns["price"]
    col.numpy()
    col.to_device("cpu")
    np.asarray(col)
    assert sb.WHOLE_READS["columns"] == 3
    new.gather()
    assert sb.WHOLE_READS["columns"] == 3 + len(new.columns)
    # without a mesh a placed dataset is flattened onto the mesh's first
    # device and comes back unplaced
    flat, _ = store.repartition(placed, by_part)
    assert sb.WHOLE_READS["columns"] == 3 + 2 * len(new.columns)
    assert all(isinstance(v, torch.Tensor) for v in flat.columns.values())
    for k, v in flat.gather().items():
        np.testing.assert_array_equal(v, new.gather()[k])


def test_sharded_repartition_needs_a_placed_dataset_and_divisible_m():
    from repro_torch.data import device_repartition as tdr
    env = TorchEnv()
    store = env.store()
    by_order, by_part = _cands(env.core)
    ds = store.write("lineitem", lineitem(), by_order)
    with pytest.raises(ValueError, match="placed"):
        tdr.sharded_repartition_dataset(ds, by_part, M, env.mesh("4"))
    three = env.sb.Mesh(["cpu"] * 3, ("data",))
    placed = env.put(env.mesh("4"), ds)
    with pytest.raises(ValueError, match="not divisible"):
        tdr.sharded_repartition_dataset(placed, by_part, M, three)
    with pytest.raises(ValueError, match="not divisible"):
        env.put(three, ds)


# -- chip_smoke.py phase 16 (a) on the CPU ----------------------------------

DISPATCHERS = {"partition_ids": "hash_partition",
               "padded_partition_ids": "hash_partition_padded",
               "scatter_permutation": "scatter_perm"}


@pytest.fixture
def fused_counts(monkeypatch):
    """Shuffles in the card's fused mode on CPU tensors, every call into a
    kernel dispatcher counted under the kernel's name (on the card each
    is one launch), as ``tests/test_torch_phase11.py`` counts them."""
    from repro_torch.data import device_repartition as tdr
    counts = dict.fromkeys(DISPATCHERS.values(), 0)
    monkeypatch.setattr(tdr, "default_mode", lambda device: "fused")
    for fn, kernel in DISPATCHERS.items():
        def counted(*a, _orig=getattr(tdr, fn), _k=kernel, **kw):
            counts[_k] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tdr, fn, counted)
    return counts


def test_phase16_dry_run_predicts_its_launches(fused_counts):
    """``chip_smoke.py`` phase 16 on the CPU at a small lineitem, the
    shuffles in the card's fused mode: every mesh's shards bit-equal to
    the host backend's layout, and the dispatcher calls of each step equal
    ``P16_LAUNCHES`` (a source hash and order and a destination scatter
    per block)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    import lachesis_torch
    import repro_torch.core as tcore
    from repro_torch.data.partition_store import export_layout
    rng = np.random.default_rng(10)
    n = 30_000
    li = {"orderkey": rng.integers(0, 7_500, n),
          "partkey": rng.integers(0, 1_000, n),
          "qty": rng.integers(1, 50, n).astype(np.float32),
          "price": rng.normal(100, 20, n).astype(np.float32)}
    wl = lachesis_torch.Workload("sf10")
    s = wl.scan("lineitem")
    wl.partition(s["orderkey"])
    wl.partition(s["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    host = lachesis_torch.Session(num_workers=chip_smoke.M, backend="host")
    host.write("lineitem", li, by_order)
    want = export_layout(host.repartition("lineitem", by_part)[0])

    def reset():
        for k in fused_counts:
            fused_counts[k] = 0

    tables = chip_smoke.tpch_tables(np, 0.002)
    out = chip_smoke.p16_mesh(torch, np, lachesis_torch, tcore, li, want,
                              tables, "the CPU (dry run)", reset,
                              lambda: dict(fused_counts), device="cpu")
    assert out["launches"] == chip_smoke.P16_LAUNCHES | {
        "cards": chip_smoke.p16_card_launches(1)}
    with pytest.raises(AssertionError, match="differs"):
        bad = dict(want, columns=dict(want["columns"]))
        bad["columns"]["qty"] = bad["columns"]["qty"] + 1
        chip_smoke.p16_mesh(torch, np, lachesis_torch, tcore, li, bad,
                            tables, "the CPU (dry run)", reset,
                            lambda: dict(fused_counts), device="cpu",
                            steps=("4",))
