"""Card-only cases of the torch port: the hand-written CUDA kernels against
their plain torch versions, and the device session against the host one.

Every case carries the ``cuda`` marker and skips where no card is present
(the decision is taken inside the fixture, so every pytest worker collects
the same tests).  This file imports torch and the port only — no JAX — so
it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis_torch  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.executor import TableVal  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as tk  # noqa: E402
from repro_torch.kernels.hash_partition import ops  # noqa: E402
from repro_torch.kernels.hash_partition import ref as tref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_SHAPES = [(0, 4), (1, 1), (7, 4), (33, 32), (2049, 256), (100_000, 32),
               (100_000, 4095), (1 << 20, 256)]


@pytest.mark.parametrize("n,m", CARD_SHAPES)
def test_cuda_kernels_match_twins(cuda, n, m):
    keys = torch.from_numpy(np.random.default_rng(n + m).integers(
        -2 ** 31, 2 ** 31 - 1, n).astype(np.int32)).to(cuda)
    p, c = tk.hash_partition(keys, m)
    rp, rc = tref.hash_partition_ref(keys, m)
    assert torch.equal(p, rp) and torch.equal(c, rc)
    for n_valid in (0, n + 5, n - n // 3):     # all padding, none, some
        pp, pc = tk.hash_partition_padded(keys, n_valid, m)
        rpp, rpc = tref.hash_partition_padded_ref(keys, n_valid, m)
        assert torch.equal(pp, rpp) and torch.equal(pc, rpc)
    dest = tk.scatter_perm(pp, pc)
    torch.cuda.synchronize()
    assert torch.equal(dest, tref.scatter_perm_ref(pp, pc))


def test_cuda_scatter_perm_sentinels_and_stability(cuda):
    """Pids outside [0, bins) move no real row; equal pids keep their
    input order."""
    pids = torch.tensor([2, -1, 0, 7, 2, 1, 3, 0], dtype=torch.int32,
                        device=cuda)
    counts = torch.tensor([2, 1, 2], dtype=torch.int32, device=cuda)
    dest = tk.scatter_perm(pids, counts).cpu().numpy()
    real = np.array([True, False, True, False, True, True, False, True])
    np.testing.assert_array_equal(dest[real], [3, 0, 4, 2, 1])


def test_cuda_kernels_reject_too_many_bins(cuda):
    keys = torch.zeros(16, dtype=torch.int32, device=cuda)
    limit = tk.max_bins()
    assert limit >= 4096
    with pytest.raises(ValueError, match="bins"):
        tk.hash_partition(keys, limit + 1)
    with pytest.raises(ValueError, match="bins"):
        tk.scatter_perm(keys, torch.zeros(limit + 1, dtype=torch.int32,
                                          device=cuda))


def test_cuda_kernels_reject_too_many_rows(cuda):
    """Row counts past int32 raise instead of overflowing the int32
    destinations and tile bases (8 GiB, never initialized)."""
    big = torch.empty(tk.MAX_ROWS + 1, dtype=torch.int32, device=cuda)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    try:
        with pytest.raises(ValueError, match="rows"):
            tk.hash_partition(big, 4)
        with pytest.raises(ValueError, match="rows"):
            tk.hash_partition_padded(big, 10, 3)
        with pytest.raises(ValueError, match="rows"):
            tk.scatter_perm(big, counts)
    finally:
        del big
        torch.cuda.empty_cache()


def test_cuda_launch_counters(cuda):
    tk.reset_launches()
    keys = torch.arange(1000, dtype=torch.int32, device=cuda)
    pids, counts = ops.partition_ids(keys, 8)
    ops.scatter_permutation(pids, counts)
    ops.padded_partition_ids(keys, 900, 8)
    assert tk.LAUNCHES == {"hash_partition": 1, "hash_partition_padded": 1,
                           "scatter_perm": 1}


@pytest.mark.parametrize("dtype", ["int64", "float32", "float64", "bool"])
def test_cuda_key_normalization_matches_cpu(cuda, dtype):
    rng = np.random.default_rng(3)
    keys = {"int64": rng.integers(-2 ** 40, 2 ** 40, 5000),
            "float32": rng.normal(size=5000).astype(np.float32),
            "float64": rng.normal(size=5000) * 1e6,
            "bool": rng.integers(0, 2, 5000).astype(bool)}[dtype]
    want_p, want_c = tdr.device_partition_ids(keys, 32, device="cpu")
    got_p, got_c = tdr.device_partition_ids(keys, 32, device=cuda)
    assert torch.equal(got_p.cpu(), want_p) and torch.equal(got_c.cpu(),
                                                            want_c)
    dev_p, _ = tdr.device_partition_ids(torch.from_numpy(keys).to(cuda), 32)
    assert torch.equal(dev_p.cpu(), want_p)


def _reddit():
    rng = np.random.default_rng(0)
    subs = {"author": rng.integers(0, 800, 20_000).astype(np.int64),
            "score": rng.normal(size=20_000).astype(np.float32),
            "ups": rng.integers(0, 1000, 20_000).astype(np.int32)}
    auths = {"author": np.arange(800, dtype=np.int64),
             "karma": rng.normal(size=800)}
    return {"submissions": subs, "authors": auths}


@pytest.mark.parametrize("partitioned", [False, True])
def test_cuda_session_matches_host(cuda, partitioned):
    """write → run → d2d repartition on the card equals the host backend,
    and the run went through the kernels."""
    tables = _reddit()
    out = {}
    tk.reset_launches()
    for backend in ("device", "host"):
        sess = lachesis_torch.Session(num_workers=16, backend=backend)
        wl = tcore.author_integrator()
        for name, data in tables.items():
            cand = tcore.enumerate_candidates(wl.graph, name)[0] \
                if partitioned else None
            sess.write(name, data, cand)
        res = sess.run(wl)
        new, _ = sess.repartition(
            "submissions", tcore.enumerate_candidates(wl.graph,
                                                      "authors")[0])
        out[backend] = (res, new.gather(), sess)
    (dres, dnew, dsess), (hres, hnew, _) = out["device"], out["host"]
    assert dsess.device.type == "cuda"
    assert dsess.store.write_log[-1]["path"] == "d2d"
    assert dres.stats.shuffles_elided == hres.stats.shuffles_elided
    assert dres.stats.shuffles_performed == hres.stats.shuffles_performed
    for nid, h in hres.values.items():
        if isinstance(h, TableVal):
            d = dres.values[nid]
            np.testing.assert_array_equal(d.counts, h.counts)
            for k in h.columns:
                np.testing.assert_array_equal(d.columns[k], h.columns[k])
    for k in hnew:
        np.testing.assert_array_equal(dnew[k], hnew[k])
    assert tk.LAUNCHES["scatter_perm"] > 0
    assert tk.LAUNCHES["hash_partition"] > 0
    if not partitioned:
        assert tk.LAUNCHES["hash_partition_padded"] > 0
