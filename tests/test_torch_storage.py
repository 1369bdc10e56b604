"""The durable store tier of the torch port (DESIGN §10) against the
reference's single-node storage cases, and across packages.

Every case of ``tests/test_storage.py`` that needs no cluster and no
Autopilot runs here against ``repro_torch`` on both backends (the device
backend on CPU tensors): round trip, restored partitioners, unsafe names,
the catalog's worker count, generation continuity and disk GC, the crash
matrix, the eviction loop, autoflush, executor I/O, cross-session elision,
``decisions.log`` and plan-cache pins across a restart.

Cross-package parity is bit for bit: a store written by either package
reopens in the other with equal columns, counts, generations, signature
sets and capacity maps; the same data gives byte-equal segments and
manifests equal apart from timestamps; and a ``decisions.log`` written by
the reference's Autopilot is explained identically by the port.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.executor import TableVal  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402
from repro_torch.data.storage import RestoredPartitioner  # noqa: E402
from repro_torch.data.storage.durable import DurableStore  # noqa: E402
from repro_torch.data.storage.manifest import (gen_dirname,  # noqa: E402
                                               manifest_filename)

BACKENDS = ["host", "device"]


def _store(root=None, backend="host", **kw):
    return PartitionStore(num_workers=kw.pop("num_workers", 4),
                          backend=backend, device="cpu", root=root, **kw)


def _open(root, backend="host", **kw):
    return PartitionStore.open(root, backend=backend, device="cpu", **kw)


def _keyed_candidate(core=tcore, dataset="d"):
    wl = core.Workload("w")
    ds = wl.scan(dataset)
    wl.partition(ds["k"])
    return core.enumerate_candidates(wl.graph, dataset)[0]


def _data(n=120, seed=0, dtype=np.int64):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 37, size=n).astype(dtype),
            "v": np.arange(n, dtype=np.float32) + seed}


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_datasets_equal(a, b):
    assert a.generation == b.generation
    assert a.num_rows == b.num_rows
    assert a.capacity == b.capacity
    np.testing.assert_array_equal(a.counts, b.counts)
    ga, gb = a.gather(), b.gather()
    assert set(ga) == set(gb)
    for k in ga:
        assert ga[k].dtype == gb[k].dtype
        np.testing.assert_array_equal(ga[k], gb[k])


# ---------------------------------------------------------------------------
# round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_roundtrip_bit_identical(tmp_path, backend):
    root = str(tmp_path / "store")
    ds = _store(root, backend).write("d", _data(), _keyed_candidate())
    d2 = _open(root).read("d")
    assert d2.spilled                       # reopened columns are memmaps
    _assert_datasets_equal(ds, d2)
    assert d2.partitioner.signature() == ds.partitioner.signature()


def test_restored_partitioner_matches_but_cannot_dispatch(tmp_path):
    root = str(tmp_path / "store")
    _store(root).write("d", _data(), _keyed_candidate())
    p = _open(root).read("d").partitioner
    assert isinstance(p, RestoredPartitioner)
    assert p.is_keyed
    assert p.signature_set() == _keyed_candidate().signature_set()
    with pytest.raises(ValueError, match="restored partitioner"):
        p.key_fn()


def test_roundtrip_device_columns(tmp_path):
    """A device store persists its tensors' bits; reopening on either
    backend yields the same bits, and a device reopen prefetches the
    columns back onto the device on first read."""
    root = str(tmp_path / "store")
    ds = _store(root, "device").write("d", _data(), _keyed_candidate())
    assert ds.backend == "device"
    _assert_datasets_equal(ds.to_host(), _open(root).read("d"))
    got = _open(root, "device").read("d")    # read → host→device
    assert got.backend == "device" and not got.spilled
    assert all(isinstance(v, torch.Tensor) for v in got.columns.values())
    _assert_datasets_equal(ds.to_host(), got.to_host())


@pytest.mark.parametrize("backend", BACKENDS)
def test_unsafe_dataset_and_column_names_roundtrip(tmp_path, backend):
    root = str(tmp_path / "store")
    ds = _store(root, backend).write(
        "tenant/2026 events", {"user/id": np.arange(80), "v": np.arange(80.0)})
    got = _open(root).read("tenant/2026 events")
    _assert_datasets_equal(ds, got)
    assert set(got.gather()) == {"user/id", "v"}
    for dirpath, _dirs, _files in os.walk(str(tmp_path)):
        assert os.path.commonpath([dirpath, root]) == root \
            or dirpath == str(tmp_path)


def test_open_adopts_catalog_worker_count(tmp_path):
    root = str(tmp_path / "store")
    _store(root).write("d", _data())
    assert _open(root, num_workers=16).m == 4
    assert lachesis_torch.Session(store_path=root, num_workers=16,
                                  device="cpu").num_workers == 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_generation_continuity_and_disk_retention(tmp_path, backend):
    root = str(tmp_path / "store")
    s = _store(root, backend, max_retired_generations=2)
    for i in range(4):
        s.write("d", _data(seed=i), _keyed_candidate())
    assert s.generation_of("d") == 3

    s2 = _open(root, backend)
    assert s2.generation_of("d") == 3
    # a fresh process resolves retained generations from disk...
    _assert_datasets_equal(s2.read("d", generation=2),
                           s.read("d", generation=2))
    # ...and GC pruned past the retention window
    ds_dir = os.path.join(root, "datasets", "d")
    assert not os.path.exists(os.path.join(ds_dir, manifest_filename(0)))
    assert not os.path.exists(os.path.join(ds_dir, gen_dirname(0)))
    new, _ = s2.repartition(s2.read("d"), _keyed_candidate(), swap=True)
    assert new.generation == 4
    if backend == "device":
        assert s2.write_log[-1]["path"] == "d2d"


# ---------------------------------------------------------------------------
# crash safety: every partial-write shape reopens to a consistent generation
# ---------------------------------------------------------------------------

def _truncate_segment(ds_dir):
    seg = os.path.join(ds_dir, gen_dirname(1), "k.seg")
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) // 2)
    return 0


def _drop_manifest(ds_dir):
    os.remove(os.path.join(ds_dir, manifest_filename(1)))
    return 0


def _tear_manifest(ds_dir):
    with open(os.path.join(ds_dir, manifest_filename(1)), "w") as f:
        f.write('{"name": "d", "gener')        # torn mid-write
    return 0


def _drop_current(ds_dir):
    os.remove(os.path.join(ds_dir, "CURRENT"))
    return 1                                  # newest valid generation


def _leave_tmp_files(ds_dir):
    for junk in ("CURRENT.tmp", manifest_filename(2) + ".tmp",
                 os.path.join(gen_dirname(1), "v.seg.tmp")):
        with open(os.path.join(ds_dir, junk), "w") as f:
            f.write("partial")
    return 1


CRASHES = {"truncated_segment": _truncate_segment,
           "missing_manifest": _drop_manifest,
           "torn_manifest": _tear_manifest,
           "missing_current": _drop_current,
           "leftover_tmp_files": _leave_tmp_files}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("crash", sorted(CRASHES))
def test_crash_matrix_reopens_consistently(tmp_path, crash, backend):
    root = str(tmp_path / "store")
    s = _store(root, backend)
    gens = [s.write("d", _data(seed=1), _keyed_candidate()),
            s.write("d", _data(seed=2), _keyed_candidate())]
    want = CRASHES[crash](os.path.join(root, "datasets", "d"))
    got = _open(root, backend).read("d")
    assert got.generation == want
    _assert_datasets_equal(gens[want].to_host(), got.to_host())


def test_empty_root_opens_empty(tmp_path):
    s = _open(str(tmp_path / "fresh"))
    assert s.datasets == {}
    assert s.is_durable


def test_cluster_root_is_refused(tmp_path):
    """A root that holds a cluster store never opens as a single node: a
    ``cluster.json`` that names no nodes is refused as the reference
    refuses it, and a real one opens as a cluster store."""
    from repro.data.partition_store import PartitionStore as JStore
    root = tmp_path / "cluster"
    root.mkdir()
    (root / "cluster.json").write_text("{}")
    with pytest.raises(KeyError) as want:
        JStore.open(str(root))
    with pytest.raises(KeyError) as got:
        _open(str(root))
    assert str(got.value) == str(want.value)
    (root / "cluster.json").write_text(json.dumps({"nodes": ["a", "b"]}))
    store = _open(str(root), num_workers=4)
    assert store.is_cluster and not store.spill("missing")
    assert store.directory.nodes == ("a", "b")


# ---------------------------------------------------------------------------
# eviction loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_spill_and_rehydrate_bit_identical(tmp_path, backend):
    root = str(tmp_path / "store")
    s = _store(root, backend)
    ds = s.write("d", _data(400))
    before = {k: np.array(v) for k, v in ds.gather().items()}
    assert s.spill("d")
    assert s.is_spilled("d")
    assert s.resident_bytes() == 0
    assert all(isinstance(v, np.memmap) for v in ds.columns.values())
    after = s.datasets["d"].gather()         # lazy memmap read-through
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    assert s.prefetch("d")
    assert not s.is_spilled("d")
    assert s.resident_bytes() > 0
    want = torch.Tensor if backend == "device" else np.ndarray
    assert all(isinstance(v, want) for v in s.datasets["d"].columns.values())
    io = s.io_snapshot()
    assert io["spills"] == 1 and io["rehydrations"] == 1
    assert io["rehydrated_bytes"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_memory_budget_evicts_coldest_first(tmp_path, backend):
    s = _store(str(tmp_path / "store"), backend)
    s.write("a", {"x": np.arange(400, dtype=np.float64)})
    s.write("b", {"x": np.arange(400, dtype=np.float64)})
    per_ds = s.resident_bytes() // 2
    s.read("a")                              # a is now hotter than b
    s.memory_budget_bytes = per_ds + per_ds // 2   # room for one dataset
    assert s._maybe_evict() == 1
    assert s.is_spilled("b") and not s.is_spilled("a")
    assert s.resident_bytes() <= s.memory_budget_bytes


@pytest.mark.parametrize("backend", BACKENDS)
def test_budget_on_write_keeps_store_under_budget(tmp_path, backend):
    s = _store(str(tmp_path / "store"), backend, memory_budget_bytes=2000)
    for i in range(4):
        s.write(f"d{i}", {"x": np.arange(300, dtype=np.float64) + i})
        assert s.resident_bytes() <= 2000
    assert any(s.is_spilled(f"d{i}") for i in range(4))
    for i in range(4):                       # everything still readable
        got = np.sort(s.read(f"d{i}").gather()["x"])
        np.testing.assert_array_equal(got,
                                      np.arange(300, dtype=np.float64) + i)


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_size_column_does_not_wedge_eviction(tmp_path, backend):
    s = _store(str(tmp_path / "store"), backend)
    s.write("z", {"k": np.arange(64, dtype=np.int64),
                  "empty": np.zeros((64, 0), np.float32)})
    s.write("big", {"x": np.arange(600, dtype=np.float64)})
    s.memory_budget_bytes = 8           # force eviction of everything
    s._maybe_evict()                    # must terminate
    assert s.is_spilled("z") and s.is_spilled("big")
    got = s.datasets["z"].gather()
    assert got["empty"].shape == (64, 0)
    np.testing.assert_array_equal(np.sort(got["k"]), np.arange(64))


@pytest.mark.parametrize("backend", BACKENDS)
def test_budget_counts_and_spills_retired_generations(tmp_path, backend):
    root = str(tmp_path / "store")
    s = _store(root, backend)
    s.write("d", _data(400, seed=1))
    base = s.resident_bytes()
    s.write("d", _data(400, seed=2), _keyed_candidate())   # gen0 retired
    assert s.resident_bytes() > base
    s.memory_budget_bytes = base + base // 2
    s._maybe_evict()
    assert all(old.spilled for old in s._retired["d"])
    assert not s.is_spilled("d")        # current generation stayed hot
    assert s.resident_bytes() <= s.memory_budget_bytes
    assert _open(root).generation_of("d") == 1


def test_device_read_prefetches_spilled_dataset(tmp_path):
    root = str(tmp_path / "store")
    _store(root, "device").write("d", _data(), _keyed_candidate())
    s = _open(root, "device")
    assert s.datasets["d"].spilled and s.datasets["d"].backend == "host"
    got = s.read("d")                        # device backend → prefetch
    assert got.backend == "device"
    assert s.io_snapshot()["rehydrations"] == 1
    # a host store reads straight through the memmap views instead
    h = _open(root)
    assert h.read("d").spilled and h.io_snapshot()["rehydrations"] == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_autoflush_off_requires_flush(tmp_path, backend):
    root = str(tmp_path / "store")
    s = _store(root, backend, autoflush=False)
    ds = s.write("d", _data(), _keyed_candidate())
    assert _open(root).datasets == {}        # nothing durable yet
    assert s.flush() == 1
    _assert_datasets_equal(ds.to_host(), _open(root).read("d"))
    assert s.flush() == 0                    # idempotent


# ---------------------------------------------------------------------------
# sessions: executor I/O, cross-session elision, decisions, plan pins
# ---------------------------------------------------------------------------

def _session(root=None, backend="host", **kw):
    return lachesis_torch.Session(store_path=root, backend=backend,
                                  device="cpu", **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_executor_reports_storage_io(tmp_path, backend):
    sess = _session(str(tmp_path / "store"), backend, num_workers=4)
    sess.write("events", _data(200))
    wl = tcore.Workload("w")
    t = wl.scan("events")
    wl.write(wl.partition(t["k"]), "out")
    res = sess.run(wl)
    assert res.stats.storage_io_bytes > 0    # autoflushed "out" generation
    assert res.stats.storage_io_s > 0

    mem = _session(None, backend, num_workers=4)
    mem.write("events", _data(200))
    assert mem.run(wl).stats.storage_io_bytes == 0


def _consumer(core):
    wl = core.Workload("consumer")
    t = wl.scan("events")
    p = wl.partition(t["k"])
    wl.aggregate(p, reducer="sum")
    return wl


def _final_table(res, cls):
    return [v for v in res.values.values() if isinstance(v, cls)][-1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_session_layout_reuse_elides_shuffle(tmp_path, backend):
    """Process A stores the layout its consumer wants; a fresh session B
    over the same root elides the shuffle and gives A's (and the
    reference's) result."""
    root = str(tmp_path / "store")
    a = _session(root, backend, num_workers=4)
    a.write("events", _data(800, seed=3))
    assert a.run(_consumer(tcore)).stats.shuffles_performed == 1
    a.repartition("events", tcore.enumerate_candidates(
        _consumer(tcore).graph, "events")[0])
    res_a = a.run(_consumer(tcore))
    assert res_a.stats.shuffles_elided == 1

    b = _session(root, backend)
    assert b.num_workers == 4
    res_b = b.run(_consumer(tcore))
    assert res_b.stats.shuffles_elided == 1
    assert res_b.stats.shuffles_performed == res_b.stats.shuffle_bytes == 0

    ref = lachesis.Session(num_workers=4, backend=backend)
    ref.write("events", _data(800, seed=3), jcore.enumerate_candidates(
        _consumer(jcore).graph, "events")[0])
    from repro.core.executor import TableVal as JTableVal
    want = _final_table(ref.run(_consumer(jcore)), JTableVal)
    for res in (res_a, res_b):
        got = _final_table(res, TableVal)
        np.testing.assert_array_equal(got.counts, want.counts)
        for k in want.columns:
            assert got.columns[k].dtype == want.columns[k].dtype
            np.testing.assert_array_equal(got.columns[k], want.columns[k])


def test_decision_log_survives_reopen(tmp_path):
    root = str(tmp_path / "store")
    d = DurableStore(root, num_workers=4)
    d.log_decision({"dataset": "d", "generation": 1})
    d.log_decision({"dataset": "d", "generation": 2})
    with open(d.decisions_path, "a") as f:
        f.write('{"torn":')                  # crash mid-append
    got = DurableStore(root).decisions()
    assert [r["generation"] for r in got] == [1, 2]
    assert all(r["version"] == 2 for r in got)


def test_durable_session_defaults_to_the_card(tmp_path):
    """A durable session runs on the card unless asked for the CPU; with
    no card it raises instead of opening the store on the host."""
    root = str(tmp_path / "store")
    if torch.cuda.is_available():
        assert lachesis_torch.Session(store_path=root).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            lachesis_torch.Session(store_path=root)
    assert _session(root, "device").device.type == "cpu"


def test_session_store_and_store_path_exclusive(tmp_path):
    with pytest.raises(ValueError, match="store= or store_path="):
        lachesis_torch.Session(store=_store(), store_path=str(tmp_path / "s"),
                               device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_cache_pins_valid_across_restart(tmp_path, backend):
    root = str(tmp_path / "store")
    a = _session(root, backend, num_workers=4)
    a.write("events", _data(300), _keyed_candidate(tcore, "events"))
    key_a = a.planner.plan_key(_consumer(tcore), backend)

    b = _session(root, backend)
    assert b.planner.plan_key(_consumer(tcore), backend).layout == key_a.layout
    b.run(_consumer(tcore))
    assert b.run(_consumer(tcore)).stats.plan_cache_hit is True


# ---------------------------------------------------------------------------
# cross-package parity
# ---------------------------------------------------------------------------

def _mixed_data(n=600, seed=5):
    """bool, int32, int64, float32 and float64 columns; both keys skewed
    so an adaptive store plans bucketed layouts."""
    rng = np.random.default_rng(seed)
    k = np.where(rng.random(n) < 0.5, 3, rng.integers(0, 200, n))
    i32 = np.where(rng.random(n) < 0.4, 7, rng.integers(-1000, 1000, n))
    return {"k": k.astype(np.int64),
            "flag": rng.random(n) < 0.3,
            "i32": i32.astype(np.int32),
            "f32": rng.normal(size=n).astype(np.float32),
            "f64": rng.normal(size=(n, 2))}


def _write_history(sess, core):
    """Two generations of "d" (keyed write, then a repartition) and a
    round-robin "r"."""
    wl = core.Workload("w")
    s = wl.scan("d")
    wl.partition(s["k"])
    wl.partition(s["i32"])
    by_k, by_i = core.enumerate_candidates(wl.graph, "d")
    sess.write("d", _mixed_data(), by_k)
    sess.repartition("d", by_i)
    sess.write("r", _mixed_data(300, seed=9))


def _ref_session(root, backend, adaptive):
    return lachesis.Session(num_workers=8, backend=backend, store_path=root,
                            adaptive_capacity=adaptive)


def _port_session(root, backend, adaptive=False):
    return lachesis_torch.Session(num_workers=8, backend=backend,
                                  device="cpu", store_path=root,
                                  adaptive_capacity=adaptive)


def _layout(ds):
    cm = ds.capacity_map
    return {"generation": ds.generation, "counts": np.asarray(ds.counts),
            "signature_set": (ds.partitioner.signature_set()
                              if ds.partitioner is not None else None),
            "capacities": None if cm is None else cm.capacities.tolist(),
            "columns": {k: _host(v) for k, v in ds.columns.items()},
            "num_rows": ds.num_rows, "nbytes": ds.nbytes}


def _assert_layouts_equal(got, want):
    assert got["generation"] == want["generation"]
    assert got["signature_set"] == want["signature_set"]
    assert got["capacities"] == want["capacities"]
    assert (got["num_rows"], got["nbytes"]) == (want["num_rows"],
                                                want["nbytes"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert set(got["columns"]) == set(want["columns"])
    for k, v in want["columns"].items():
        assert got["columns"][k].dtype == v.dtype, k
        assert got["columns"][k].shape == v.shape, k
        np.testing.assert_array_equal(got["columns"][k], v, err_msg=k)


LAYOUTS = {"uniform": False, "adaptive_capacity": True}


@pytest.mark.parametrize("reader", BACKENDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("writer", BACKENDS)
def test_reference_store_reopens_in_port(tmp_path, writer, layout, reader):
    root = str(tmp_path / "store")
    ref = _ref_session(root, writer, LAYOUTS[layout])
    _write_history(ref, jcore)
    if LAYOUTS[layout]:
        assert ref.read("d").capacity_map is not None
        assert ref.read("d", generation=0).capacity_map is not None
    port = _port_session(root, reader)
    assert port.num_workers == 8
    assert sorted(port.store.datasets) == sorted(ref.store.datasets)
    for name in ref.store.datasets:
        got = port.read(name)
        want_dev = reader == "device"
        assert (got.backend == "device") == want_dev
        _assert_layouts_equal(_layout(got), _layout(ref.read(name)))
    # the retained older generation resolves from disk too
    _assert_layouts_equal(_layout(port.read("d", generation=0)),
                          _layout(ref.read("d", generation=0)))


@pytest.mark.parametrize("reader", BACKENDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("writer", BACKENDS)
def test_port_store_reopens_in_reference(tmp_path, writer, layout, reader):
    root = str(tmp_path / "store")
    port = _port_session(root, writer, LAYOUTS[layout])
    _write_history(port, tcore)
    if LAYOUTS[layout]:
        assert port.read("d").capacity_map is not None
        assert port.read("d", generation=0).capacity_map is not None
    ref = lachesis.Session(backend=reader, store_path=root)
    assert ref.num_workers == 8
    assert sorted(ref.store.datasets) == sorted(port.store.datasets)
    for name in port.store.datasets:
        _assert_layouts_equal(_layout(ref.read(name)),
                              _layout(port.read(name)))
    _assert_layouts_equal(_layout(ref.read("d", generation=0)),
                          _layout(port.read("d", generation=0)))


def _store_files(root):
    out = {}
    base = os.path.join(root, "datasets")
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, base)] = path
    return out


def _manifest_sans_times(path):
    with open(path) as f:
        man = json.load(f)
    man.pop("created_at")
    for entry in man["generation_log"]:
        entry.pop("created_at")
    return man


@pytest.mark.parametrize("port_backend", BACKENDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("ref_backend", BACKENDS)
def test_same_data_gives_byte_equal_segments(tmp_path, ref_backend, layout,
                                             port_backend):
    jroot, troot = str(tmp_path / "ref"), str(tmp_path / "port")
    _write_history(_ref_session(jroot, ref_backend, LAYOUTS[layout]), jcore)
    _write_history(_port_session(troot, port_backend, LAYOUTS[layout]),
                   tcore)
    jfiles, tfiles = _store_files(jroot), _store_files(troot)
    assert sorted(tfiles) == sorted(jfiles)
    assert any(f.endswith(".seg") for f in jfiles)
    for rel, jpath in jfiles.items():
        if os.path.basename(rel).startswith("manifest-"):
            assert _manifest_sans_times(tfiles[rel]) == \
                _manifest_sans_times(jpath), rel
        else:
            with open(jpath, "rb") as a, open(tfiles[rel], "rb") as b:
                assert a.read() == b.read(), rel
    with open(os.path.join(jroot, "catalog.json")) as a, \
            open(os.path.join(troot, "catalog.json")) as b:
        ja, tb = json.load(a), json.load(b)
    assert {k: v for k, v in ja.items() if k != "created_at"} == \
        {k: v for k, v in tb.items() if k != "created_at"}


def test_reference_decisions_log_is_explained_by_port(tmp_path):
    """The reference's Autopilot logs its why-records into decisions.log;
    a port session over the same root explains them identically."""
    from repro.service.observer import LogicalClock
    root = str(tmp_path / "store")
    a = lachesis.Session(store_path=root, num_workers=4)
    a.write("events", _data(800, seed=3))
    ap = a.autopilot(clock=LogicalClock())
    a.run(_consumer(jcore))
    a.run(_consumer(jcore))
    rep = ap.tick()
    assert [d.dataset for d in rep.applied] == ["events"]

    want = lachesis.Session(store_path=root).explain_decisions()
    got = _session(root).explain_decisions()
    assert want and got == want
    assert _session(root).explain_decisions(limit=1) == want[-1:]
    # and the store the Autopilot repartitioned elides in the port
    res = _session(root, "device").run(_consumer(tcore))
    assert res.stats.shuffles_elided == 1
    assert _session(str(tmp_path / "empty")).explain_decisions() == []
