"""The torch port's device shuffle against the JAX package (DESIGN §5).

``device_rebucket_full``, ``device_scatter_padded`` and
``device_repartition_dataset`` of the port must give the reference's bits:
the same columns, dtypes, counts and padded layouts.  On the CPU the port's
fused mode runs the kernels' plain versions; hostperm computes the
permutation on the host, as in the reference.  Inputs are made with numpy
from a seed and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import enumerate_candidates as j_enumerate  # noqa: E402
from repro.core.dsl import author_integrator as j_author  # noqa: E402
from repro.data import device_repartition as jdr  # noqa: E402
from repro.data.capacity import CapacityMap as JCapacityMap  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro_torch.core import author_integrator, enumerate_candidates  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.data.capacity import CapacityMap  # noqa: E402
from repro_torch.data.partition_store import (PartitionStore,  # noqa: E402
                                              export_layout, import_layout)

MODES = ("fused", "hostperm")


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 10_000, n).astype(np.int64),
            "v32": rng.normal(size=n).astype(np.float32),
            "v64": rng.normal(size=n),
            "i32": rng.integers(0, 9, n).astype(np.int32),
            "flag": rng.integers(0, 2, n).astype(bool),
            "mat": rng.normal(size=(n, 3)).astype(np.float32)}


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _assert_same_columns(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n,m", [(700, 9), (900, 11), (64, 1)])
def test_rebucket_full_matches_jax(mode, n, m):
    cols = _cols(n, seed=n)
    keys = cols["k"]
    want = jdr.device_rebucket_full(cols, keys, m, mode="hostperm")
    got = tdr.device_rebucket_full(cols, keys, m, mode=mode, device="cpu")
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == np.int64
    _assert_same_columns(got.columns, want.columns)
    # every column (64-bit ones too) is relayed as a device tensor
    assert set(got.device_columns) == set(got.columns)
    for k, v in got.device_columns.items():
        np.testing.assert_array_equal(_np(v), got.columns[k])


def test_rebucket_fused_pallas_matches_port_fused():
    """The reference's TPU-default fused plan (Pallas kernels, interpret
    mode) against the port's fused plan (plain versions on the CPU)."""
    cols = _cols(500, seed=3)
    want = jdr.device_rebucket_full(cols, cols["k"], 7, mode="fused",
                                    interpret=True, use_kernel=True)
    got = tdr.device_rebucket_full(cols, cols["k"], 7, mode="fused",
                                   device="cpu")
    np.testing.assert_array_equal(got.counts, want.counts)
    _assert_same_columns(got.columns, want.columns)


def test_chained_rebucket_relays_fresh_key():
    rng = np.random.default_rng(8)
    n, m = 600, 7
    cols = {"v": rng.normal(size=n).astype(np.float32)}
    key1 = rng.integers(0, 500, n).astype(np.int32)
    key2 = rng.integers(0, 500, n).astype(np.int32)
    r1 = tdr.device_rebucket_full(cols, key1, m, device="cpu")
    j1 = jdr.device_rebucket_full(cols, key1, m)
    pids1, _ = tdr.shuffle_pids(key1, m, mode="hostperm", device="cpu")
    k2 = key2[np.argsort(pids1, kind="stable")]   # rows in r1's order
    r2 = tdr.device_rebucket_full(r1.columns, k2, m, device="cpu",
                                  device_columns=r1.device_columns)
    j2 = jdr.device_rebucket_full(j1.columns, k2, m,
                                  device_columns=j1.device_columns)
    _assert_same_columns(r2.columns, j2.columns)


def test_rebucket_empty():
    got = tdr.device_rebucket_full({"v": np.zeros(0, np.float32)},
                                   np.zeros(0, np.int64), 4, device="cpu")
    assert got.counts.tolist() == [0, 0, 0, 0]
    assert got.columns["v"].size == 0 and "__key__" in got.columns


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bucketed", [False, True])
def test_scatter_padded_matches_jax(mode, bucketed):
    rng = np.random.default_rng(11)
    n, m = 700, 6
    data = {"k": rng.integers(0, 50, n).astype(np.int64),
            "v": rng.normal(size=n).astype(np.float32),
            "d": rng.normal(size=(n, 2))}
    jp, jc = jdr.device_partition_ids(data["k"], m)
    tp, tc = tdr.device_partition_ids(data["k"], m, device="cpu")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    counts = tc.numpy().astype(np.int64)
    kw_j, kw_t = {}, {}
    if bucketed:
        kw_j["capacity_map"] = JCapacityMap.from_counts(counts)
        kw_t["capacity_map"] = CapacityMap.from_counts(counts)
    want = jdr.device_scatter_padded(data, jp, counts, mode="hostperm",
                                     **kw_j)
    got = tdr.device_scatter_padded(data, tp, counts, mode=mode,
                                    device="cpu", **kw_t)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _assert_same_columns(got, want)


def test_scatter_padded_explicit_capacity_and_empty():
    rng = np.random.default_rng(4)
    data = {"k": rng.integers(0, 50, 300).astype(np.int64)}
    tp, tc = tdr.device_partition_ids(data["k"], 4, device="cpu")
    counts = tc.numpy().astype(np.int64)
    cap = int(counts.max()) + 3
    got = tdr.device_scatter_padded(data, tp, counts, capacity=cap,
                                    device="cpu")
    want = jdr.device_scatter_padded(data, np.asarray(tp), counts,
                                     capacity=cap)
    _assert_same_columns(got, want)
    empty = {"v": np.zeros(0, np.float32), "d": np.zeros(0, np.float64)}
    got = tdr.device_scatter_padded(empty, np.zeros(0, np.int32),
                                    np.zeros(4, np.int64), device="cpu")
    want = jdr.device_scatter_padded(empty, np.zeros(0, np.int32),
                                     np.zeros(4, np.int64))
    _assert_same_columns(got, want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_overflow_error_text_identical(bucketed):
    rng = np.random.default_rng(4)
    data = {"k": rng.integers(0, 50, 300).astype(np.int64)}
    tp, tc = tdr.device_partition_ids(data["k"], 4, device="cpu")
    counts = tc.numpy().astype(np.int64)
    msgs = []
    for mod, cm_cls, pids, kw in ((jdr, JCapacityMap, np.asarray(tp), {}),
                                  (tdr, CapacityMap, tp, {"device": "cpu"})):
        if bucketed:
            caps = counts.copy()
            caps[2] -= 1
            kw["capacity_map"] = cm_cls.of(caps)
        else:
            kw["capacity"] = int(counts.max()) - 1
        with pytest.raises(ValueError) as ei:
            mod.device_scatter_padded(data, pids, counts, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "capacity" in msgs[0]


def test_plan_builds_flat_inside_a_bucket():
    """Different Ns inside one power-of-two bucket reuse one plan — the
    counterpart of the reference's no-retrace guarantee."""
    tdr.clear_plan_cache()
    rng = np.random.default_rng(1)
    for n in (900, 1000, 1024):
        cols = {"v": rng.normal(size=n).astype(np.float32)}
        keys = rng.integers(0, 10_000, n).astype(np.int64)
        counts = tdr.device_rebucket_full(cols, keys, 8, device="cpu").counts
        assert int(counts.sum()) == n
    stats = tdr.plan_cache_stats()
    assert stats["plans"] == 1 and stats["traces"] == 1, stats
    assert stats["calls"] == 3


@pytest.mark.parametrize("mode", MODES)
def test_store_write_plan_builds_flat_across_skew(mode):
    """Writes of one shape whose key skew (hence capacity) differs share
    one scatter plan: capacity rides as data, not as a cache key."""
    wl = author_integrator()
    cand = enumerate_candidates(wl.graph, "submissions")[0]
    tdr.clear_plan_cache()
    store = PartitionStore(8, device="cpu")

    def batch(seed):
        r = np.random.default_rng(seed)
        skew = 40 if seed % 2 else 60
        return {"author": r.integers(0, skew, 2000).astype(np.int64),
                "score": r.normal(size=2000).astype(np.float32)}

    caps = []
    store.write("a", batch(0), cand)
    caps.append(store.read("a").capacity)
    t1 = tdr.plan_cache_stats()["traces"]
    for i in range(4):
        store.write(f"b{i}", batch(i + 1), cand)
        caps.append(store.read(f"b{i}").capacity)
    stats = tdr.plan_cache_stats()
    assert len(set(caps)) > 1
    assert len({tdr.shape_bucket(8 * c) for c in caps}) == 1, caps
    assert stats["traces"] == t1, stats


@pytest.mark.parametrize("adaptive", [False, True])
def test_d2d_repartition_from_jax_layout(adaptive, monkeypatch):
    """A layout written by the JAX store, imported as numpy, repartitions
    in the port exactly as it does in the reference — without a host
    gather."""
    rng = np.random.default_rng(0)
    n = 3000
    data = {"author": (rng.zipf(1.6, n) % 500).astype(np.int64),
            "score": rng.normal(size=n).astype(np.float32),
            "ups": rng.integers(0, 1000, n).astype(np.int32)}
    jwl, twl = j_author(), author_integrator()
    jstore = JStore(8, backend="device", adaptive_capacity=adaptive)
    jds = jstore.write("submissions", data)
    tstore = PartitionStore(8, device="cpu", adaptive_capacity=adaptive)
    tds = tstore.import_layout(
        "submissions", {k: np.asarray(v) for k, v in jds.columns.items()},
        jds.counts, None, capacity_map=jds.capacity_map and CapacityMap.of(
            jds.capacity_map.capacities))
    assert tds.nbytes == jds.nbytes

    monkeypatch.setattr(type(tds), "gather", lambda self: 1 / 0)
    new_t, moved_t = tstore.repartition(
        tds, enumerate_candidates(twl.graph, "submissions")[0])
    monkeypatch.undo()
    new_j, moved_j = jstore.repartition(
        jds, j_enumerate(jwl.graph, "submissions")[0])

    assert tstore.write_log[-1]["path"] == "d2d"
    assert moved_t == moved_j
    np.testing.assert_array_equal(new_t.counts, new_j.counts)
    assert (new_t.capacity_map is None) == (new_j.capacity_map is None)
    if adaptive:
        np.testing.assert_array_equal(new_t.capacity_map.capacities,
                                      new_j.capacity_map.capacities)
    _assert_same_columns(new_t.columns, new_j.columns)
    _assert_same_columns(new_t.gather(), new_j.gather())
    # export → import round trip is bit-exact
    exp = export_layout(new_t)
    cm = None if exp["capacities"] is None else CapacityMap.of(
        exp["capacities"])
    back = import_layout(exp["columns"], exp["counts"], new_t.partitioner,
                         capacity_map=cm, device="cpu", name="x")
    _assert_same_columns(back.columns, new_t.columns)


def test_flatten_dataset_matches_gather():
    rng = np.random.default_rng(5)
    data = {"author": rng.integers(0, 99, 777).astype(np.int64),
            "score": rng.normal(size=777).astype(np.float32)}
    ds = PartitionStore(6, device="cpu").write("s", data)
    jds = JStore(6).write("s", data)
    _assert_same_columns(ds.gather(), jds.gather())
    _assert_same_columns(tdr.flatten_dataset(ds), jds.gather())
    dev_only = tdr.device_flat_columns(ds)
    assert set(dev_only) == set(data)


def test_write_layout_matches_jax():
    rng = np.random.default_rng(5)
    counts = np.array([3, 0, 5, 2], np.int64)
    n = int(counts.sum())
    flat = {"a": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 9, n).astype(np.int64)}
    want = JStore(4).write_layout("d", flat, counts, None)
    for backend in ("host", "device"):
        got = PartitionStore(4, backend=backend, device="cpu").write_layout(
            "d", flat, counts, None)
        np.testing.assert_array_equal(got.counts, want.counts)
        _assert_same_columns(got.columns, want.columns)


def test_import_layout_validates_shapes():
    with pytest.raises(ValueError, match="uniform layout"):
        import_layout({"a": np.zeros(5)}, np.array([1, 1]), None,
                      device="cpu")
    with pytest.raises(ValueError, match="slots"):
        import_layout({"a": np.zeros(5)}, np.array([1, 1]), None,
                      capacity_map=CapacityMap.of([2, 2]), device="cpu")
