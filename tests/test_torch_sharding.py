"""The torch port's mesh placement (``core/sharding_bridge.py``), the
store's ``repartition(mesh=)`` and ``apply_decision(mesh=)``, and the
sharding advisor (``core/sharding_advisor.py``), against the JAX package.

The reference's mesh cases (``tests/test_device_repartition.py``,
``tests/test_shuffle_plan.py``) run on a one-device CPU mesh; here they
run on the port's one-device CPU :class:`Mesh` (meshes of several
positions: ``tests/test_torch_mesh_store.py``).  Layouts are compared bit for bit with the reference's after
the same calls; the advisor is held to the reference's own tests with an
injected ``analyze``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh as JMesh  # noqa: E402
from repro.core import advisor as jadvisor  # noqa: E402
from repro.core import author_integrator as j_author  # noqa: E402
from repro.core import enumerate_candidates as j_enumerate  # noqa: E402
from repro.core import sharding_advisor as jsa  # noqa: E402
from repro.core import sharding_bridge as jsb  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro_torch.core import advisor as tadvisor  # noqa: E402
from repro_torch.core import author_integrator, enumerate_candidates  # noqa: E402
from repro_torch.core import sharding_advisor as tsa  # noqa: E402
from repro_torch.core.sharding_bridge import (Mesh, NamedSharding, P,  # noqa: E402
                                              ShardedColumn,
                                              device_put_dataset,
                                              sharding_for, sharding_of,
                                              specs_match,
                                              would_elide_collective)
from repro_torch.data.partition_store import PartitionStore  # noqa: E402

CPU_MESH = Mesh([torch.device("cpu")], ("data",))


def _reddit(n_sub=500, n_auth=100, seed=0):
    rng = np.random.default_rng(seed)
    subs = {"author": rng.integers(0, n_auth, n_sub).astype(np.int64),
            "score": rng.normal(size=n_sub).astype(np.float32),
            "ups": rng.integers(0, 1000, n_sub).astype(np.int32)}
    auths = {"author": np.arange(n_auth, dtype=np.int64),
             "karma": rng.normal(size=n_auth).astype(np.float32)}
    return {"submissions": subs, "authors": auths}


def _cands():
    return (j_enumerate(j_author().graph, "submissions")[0],
            enumerate_candidates(author_integrator().graph, "submissions")[0])


def _same_layout(got, want):
    np.testing.assert_array_equal(np.asarray(got.counts),
                                  np.asarray(want.counts))
    assert set(got.columns) == set(want.columns)
    for k, w in want.columns.items():
        g = got.columns[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_mesh_shape_and_equality():
    m = Mesh([torch.device("cpu")], ("data",))
    assert m.shape == {"data": 1} and m == CPU_MESH
    assert hash(m) == hash(CPU_MESH)
    assert Mesh([["cpu"]], ("data", "model")).shape == {"data": 1,
                                                        "model": 1}
    with pytest.raises(ValueError, match="axes"):
        Mesh(["cpu"], ("data", "model"))


@pytest.mark.parametrize("axes,extra", [(("data",), 0), (("data",), 2),
                                        (("data", "model"), 1)])
def test_sharding_for_and_specs_match_the_reference(axes, extra):
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape((1,) * len(axes)), axes)
    tmesh = Mesh(np.full((1,) * len(axes), "cpu", dtype=object), axes)
    want = jsb.sharding_for(jmesh, None, axes, extra_dims=extra)
    got = sharding_for(tmesh, None, axes, extra_dims=extra)
    assert tuple(got.spec) == tuple(want.spec)
    assert got == sharding_for(tmesh, None, axes, extra_dims=extra)
    assert got != sharding_for(tmesh, None, axes, extra_dims=extra + 1)
    assert isinstance(got, NamedSharding) and got.mesh == tmesh


@pytest.mark.parametrize("a,b", [(("data",), ("data", None)),
                                 (("data", None), ("model",)),
                                 ((("data", "model"), None), (("data", "model"),)),
                                 ((None,), ()), (("data",), ()),
                                 (("data", None), (None, "data"))])
def test_specs_match_and_elision_match_the_reference(a, b):
    from jax.sharding import PartitionSpec as JP
    want = jsb.specs_match(JP(*a), JP(*b))
    assert specs_match(P(*a), P(*b)) == want
    assert would_elide_collective(P(*a), P(*b)) == \
        jsb.would_elide_collective(JP(*a), JP(*b))


def test_device_put_dataset_places_worker_axis():
    """The reference's ``test_device_put_dataset_places_worker_axis`` on the
    port: columns placed with the worker axis sharded — every dtype, the
    int64 one too (no x64 hybrid) — bits unchanged, the placement readable
    afterwards; divisibility checked before anything is placed."""
    tables = _reddit()
    _, cand = _cands()
    ds = PartitionStore(8, backend="device", device="cpu").write(
        "submissions", tables["submissions"], cand)
    placed = device_put_dataset(CPU_MESH, ds)
    for k in ("score", "author", "ups"):
        assert isinstance(placed.columns[k], ShardedColumn)
        assert sharding_of(placed, k) == sharding_for(CPU_MESH,
                                                      ds.partitioner)
        assert torch.equal(placed.columns[k].to_device("cpu"),
                           ds.columns[k])
    assert placed.columns["author"].dtype == torch.int64
    assert sharding_of(ds, "score") is None       # the input is untouched
    host = PartitionStore(8, backend="host").write(
        "submissions", tables["submissions"], cand)
    _same_layout(device_put_dataset(CPU_MESH, host), host)

    class TwoWideMesh:
        shape = {"data": 2}
    bad = PartitionStore(3, backend="host").write("s", tables["authors"])
    with pytest.raises(ValueError, match="not divisible"):
        device_put_dataset(TwoWideMesh(), bad)


def test_a_mesh_of_two_devices_places_two_blocks():
    """A mesh of two positions holds two blocks of two workers each, bit
    for bit the host layout's rows; m = 3 does not divide over it."""
    ds = PartitionStore(4, backend="host").write("s", _reddit()["authors"])
    two = Mesh(["cpu", "cpu"], ("data",))
    assert sharding_for(two, None).spec == P("data", None)
    placed = device_put_dataset(two, ds)
    for k, v in ds.columns.items():
        col = placed.columns[k]
        assert sharding_of(placed, k) == sharding_for(two, None)
        shards = list(col.shards())
        assert [(i, s) for i, _, s, _ in shards] == [
            ((0,), slice(0, 2)), ((1,), slice(2, 4))]
        for _, dev, sl, t in shards:
            assert dev == torch.device("cpu")
            np.testing.assert_array_equal(t.numpy(), v[sl])
    bad = PartitionStore(3, backend="host").write("s", _reddit()["authors"])
    with pytest.raises(ValueError, match="not divisible"):
        device_put_dataset(two, bad)


def test_bucketed_layout_is_placed_unsharded():
    rng = np.random.default_rng(3)
    keys = np.concatenate([np.zeros(900, np.int64),
                           rng.integers(0, 5000, 300)])
    wl = author_integrator()
    cand = enumerate_candidates(wl.graph, "submissions")[0]
    store = PartitionStore(8, backend="device", device="cpu",
                           adaptive_capacity=True)
    ds = store.write("submissions", {"author": keys,
                                     "score": np.ones(keys.size, np.float32)},
                     cand)
    assert ds.capacity_map is not None
    placed = device_put_dataset(CPU_MESH, ds)
    assert sharding_of(placed, "score") == NamedSharding(CPU_MESH, P())
    assert placed.capacity_map is ds.capacity_map
    _same_layout(placed, ds)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_repartition_with_mesh_matches_reference(backend):
    """``repartition(mesh=)``: d2d on a device store, host gather + write on
    a host one; the layout is the reference's bit for bit, placed on the
    mesh, and the store serves the placed generation (the reference's
    ``test_d2d_repartition_stays_mesh_placed``)."""
    tables = _reddit(n_sub=400, n_auth=64)
    jcand, tcand = _cands()
    jstore = JStore(8, backend=backend)
    jds = jstore.write("submissions", tables["submissions"])
    jnew, jmoved = jstore.repartition(
        jds, jcand, mesh=JMesh(np.array(jax.devices()[:1]), ("data",)))
    tstore = PartitionStore(8, backend=backend, device="cpu")
    tds = tstore.write("submissions", tables["submissions"])
    tnew, tmoved = tstore.repartition(tds, tcand, mesh=CPU_MESH)
    assert tmoved == jmoved
    assert tstore.write_log[-1].get("path", "host") == \
        jstore.write_log[-1].get("path", "host")
    _same_layout(tnew, jnew)
    assert sharding_of(tnew, "score") == sharding_for(CPU_MESH,
                                                      tnew.partitioner)
    assert tstore.read(tnew.name) is tnew
    assert tnew.generation == jnew.generation


@pytest.mark.parametrize("backend", ["device", "host"])
def test_apply_decision_with_mesh_matches_reference(backend):
    from repro.core import HistoryStore as JHistory
    from repro_torch.core import HistoryStore as THistory
    tables = _reddit(n_sub=2000, n_auth=300, seed=1)
    got = {}
    for pkg, core, hist, store, mesh in (
            ("ref", jadvisor, JHistory(), JStore(8, backend=backend),
             JMesh(np.array(jax.devices()[:1]), ("data",))),
            ("port", tadvisor, THistory(),
             PartitionStore(8, backend=backend, device="cpu"), CPU_MESH)):
        author = j_author if pkg == "ref" else author_integrator
        enum = j_enumerate if pkg == "ref" else enumerate_candidates
        store.write("submissions", tables["submissions"])
        cand = enum(author().graph, "submissions")[0]
        dec = core.PartitioningDecision(
            dataset="submissions", candidate=cand, features=[], consumers=[],
            action_index=0, state=None, elapsed_s=0.0)
        new, moved = core.apply_decision(store, dec, mesh=mesh)
        assert store.generation_of("submissions") == 1
        got[pkg] = (new, moved)
    (jnew, jm), (tnew, tm) = got["ref"], got["port"]
    assert tm == jm
    _same_layout(tnew, jnew)
    assert sharding_of(tnew, "author") == sharding_for(CPU_MESH,
                                                       tnew.partitioner)


# -- the sharding advisor: the reference's tests, on both packages ----------

FAKE = {"baseline": {"compute_s": 1.0, "memory_s": 5.0, "collective_s": 2.0},
        "cache_seq_shard": {"compute_s": 1.0, "memory_s": 3.0,
                            "collective_s": 0.5},
        "flash_decode": {"compute_s": 1.0, "memory_s": 4.0,
                         "collective_s": 2.0}}


def _fake_analyze(arch, shape, multi_pod=False, extra_cfg=None,
                  variant=None, verbose=False):
    variant = variant or {}
    for name in ("cache_seq_shard", "flash_decode"):
        if variant.get(name):
            return dict(FAKE[name])
    return dict(FAKE["baseline"])


def _flaky(arch, shape, multi_pod=False, extra_cfg=None, variant=None,
           verbose=False):
    if variant:
        raise RuntimeError("did not lower")
    return {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}


@pytest.mark.parametrize("analyze,winner,score,errors", [
    (_fake_analyze, "cache_seq_shard", 3.0, 0), (_flaky, "baseline", 1.0, 2)])
def test_advise_matches_reference(analyze, winner, score, errors):
    want = jsa.advise("qwen1.5-110b", "decode_32k", analyze=analyze)
    got = tsa.advise("qwen1.5-110b", "decode_32k", analyze=analyze)
    assert got.winner.name == want.winner.name == winner
    assert got.dominant_term_s == want.dominant_term_s == score
    assert got.cell == want.cell
    assert [t.get("candidate") for t in got.trail] == \
        [t.get("candidate") for t in want.trail]
    assert sum("error" in t for t in got.trail) == errors
    assert len(got.trail) == 3


def test_advise_over_given_candidates_and_none_lowering():
    cands = [tsa.ShardingCandidate("accum_1", {"accum_steps": 1}),
             tsa.ShardingCandidate("x", {}, {"flash_decode": True})]
    dec = tsa.advise("internlm2-1.8b", "train_4k", candidates=cands,
                     analyze=_fake_analyze)
    assert dec.winner.name == "x" and dec.dominant_term_s == 4.0
    with pytest.raises(RuntimeError, match="no sharding candidate"):
        tsa.advise("internlm2-1.8b", "decode_32k",
                   analyze=lambda *a, **k: 1 / 0)


def test_advise_needs_an_injected_analyze(monkeypatch):
    """No longer: without ``analyze=`` the port scores candidates with its
    own dry run (``launch/dryrun.analyze_cell`` on the fake 256-rank
    world), as the reference does with its own.  On a small decode cell
    (internlm2-1.8b, 128 sequences over a 1,024-slot cache) it returns a
    decision, every default candidate in the trail with its record."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    monkeypatch.setitem(SHAPES, "decode_1k",
                        ShapeSpec("decode_1k", 1024, 128, "decode"))
    dec = tsa.advise("internlm2-1.8b", "decode_1k")
    names = [c.name for c in jsa.DEFAULT_CANDIDATES["decode"]]
    assert [t["candidate"] for t in dec.trail] == names
    assert not any("error" in t for t in dec.trail)
    assert dec.winner.name in names and dec.cell == ("internlm2-1.8b",
                                                     "decode_1k", False)
    assert dec.dominant_term_s == min(tsa.dominant_term(t)
                                      for t in dec.trail) > 0
    assert all(t["shape"] == "decode_1k" and t["chips"] == 256
               for t in dec.trail)


def test_dominant_term_and_default_candidates_match_reference():
    rec = {"compute_s": 1, "memory_s": 9, "collective_s": 3}
    assert tsa.dominant_term(rec) == jsa.dominant_term(rec) == 9
    assert {k: [(c.name, c.extra_cfg, c.variant) for c in v]
            for k, v in tsa.DEFAULT_CANDIDATES.items()} == \
        {k: [(c.name, c.extra_cfg, c.variant) for c in v]
         for k, v in jsa.DEFAULT_CANDIDATES.items()}


@pytest.mark.parametrize("backend", ["device", "host"])
def test_session_repartition_with_mesh_matches_reference(backend):
    import lachesis
    import lachesis_torch
    tables = _reddit(n_sub=600, n_auth=90, seed=2)
    jcand, tcand = _cands()
    js = lachesis.Session(num_workers=8, backend=backend)
    ts = lachesis_torch.Session(num_workers=8, backend=backend, device="cpu")
    js.write("submissions", tables["submissions"])
    ts.write("submissions", tables["submissions"])
    jnew, jmoved = js.repartition(
        "submissions", jcand,
        mesh=JMesh(np.array(jax.devices()[:1]), ("data",)))
    tnew, tmoved = ts.repartition("submissions", tcand, mesh=CPU_MESH)
    assert tmoved == jmoved and tnew.generation == jnew.generation == 1
    _same_layout(tnew, jnew)
    assert sharding_of(tnew, "ups") == sharding_for(CPU_MESH,
                                                    tnew.partitioner)
    assert ts.store.read("submissions") is tnew


def test_phase13a_dry_run():
    """``chip_smoke.py`` phase 13 (a) on the CPU at a small lineitem: the
    d2d repartition onto a one-device mesh and ``apply_decision(mesh=)``
    give the host backend's layout, placed on the mesh (the card counts
    the hash kernels' launches; their plain twins here count none)."""
    import sys
    from collections import Counter
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    import lachesis_torch
    import repro_torch.core as tcore
    from repro_torch.data.partition_store import export_layout
    from repro_torch.kernels.hash_partition import hash_partition as hp
    rng = np.random.default_rng(10)
    n = 30_000
    lineitem = {"orderkey": rng.integers(0, 7_500, n),
                "partkey": rng.integers(0, 1_000, n),
                "qty": rng.integers(1, 50, n).astype(np.float32),
                "price": rng.normal(100, 20, n).astype(np.float32)}
    wl = lachesis_torch.Workload("sf10")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    host = lachesis_torch.Session(num_workers=chip_smoke.M, backend="host")
    host.write("lineitem", lineitem, by_order)
    want = export_layout(host.repartition("lineitem", by_part)[0])
    none = {"write": Counter(), "repartition": Counter()}
    launches = chip_smoke.p13_mesh(torch, np, lachesis_torch, tcore, hp,
                                   lineitem, want, none, export_layout,
                                   "the CPU (dry run)", device="cpu")
    assert not any(launches.values())
    with pytest.raises(AssertionError, match="counts differ"):
        bad = dict(want, counts=np.roll(want["counts"], 1))
        chip_smoke.p13_mesh(torch, np, lachesis_torch, tcore, hp, lineitem,
                            bad, none, export_layout, "the CPU (dry run)",
                            device="cpu")
