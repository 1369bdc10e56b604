"""The reference's hypothesis sweeps of the single-pass device shuffle
(``tests/test_shuffle_properties.py``, DESIGN §5) held against the port.

Each draw makes one set of numpy arrays and feeds it to the JAX package
and to the port's CPU route (the hash-partition kernels' plain versions,
the ``fused`` ShufflePlans): columns, counts, padded layouts, destination
permutations and d2d-repartitioned layouts must be bit-equal to the
reference's, for any keys, every key and payload dtype the workloads use,
heavy skew (all keys equal), and zero rows.  ``max_examples`` are the
reference's or fewer.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import author_integrator as j_author  # noqa: E402
from repro.core import enumerate_candidates as j_enumerate  # noqa: E402
from repro.core.ir import _mix_hash  # noqa: E402
from repro.data import device_repartition as jdr  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro.kernels.hash_partition.hash_partition import scatter_perm  # noqa: E402
from repro_torch.core import author_integrator, enumerate_candidates  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402
from repro_torch.kernels.hash_partition import ops  # noqa: E402

KEY_DTYPES = (np.int64, np.int32, np.float32, np.float64)
PAYLOAD_DTYPES = (np.float32, np.int32, np.float64, np.int64)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@given(st.integers(2, 32),
       st.integers(0, len(KEY_DTYPES) - 1),
       st.integers(0, 3),                      # key domain exponent → skew
       st.lists(st.integers(0, 2 ** 31 - 1), min_size=0, max_size=400))
@settings(max_examples=25, deadline=None)
def test_fused_rebucket_equals_reference(m, kdt, dom, raw):
    keys = (np.array(raw, np.int64) % (4 ** dom + 1)).astype(KEY_DTYPES[kdt])
    n = keys.shape[0]
    cols = {f"c{i}": np.arange(n, dtype=dt) * (i + 1)
            for i, dt in enumerate(PAYLOAD_DTYPES)}
    cols["mat"] = np.arange(2 * n, dtype=np.float32).reshape(n, 2)

    want, want_counts = jdr.device_rebucket(cols, keys, m)
    got = tdr.device_rebucket_full(cols, keys, m, mode="fused", device="cpu")
    _same(got.counts, want_counts, "counts")
    assert set(got.columns) == set(want)
    for k in want:
        _same(got.columns[k], want[k], k)
    # and the host path's order, as the reference's property states it
    pids = np.asarray(_mix_hash(jnp.asarray(keys))).astype(np.int64) % m
    order = np.argsort(pids, kind="stable")
    np.testing.assert_array_equal(got.counts, np.bincount(pids, minlength=m))
    np.testing.assert_array_equal(got.columns["__key__"], keys[order])


@given(st.integers(2, 24),
       st.lists(st.integers(0, 2 ** 31 - 1), min_size=0, max_size=300))
@settings(max_examples=25, deadline=None)
def test_fused_scatter_padded_equals_reference(m, raw):
    keys = np.array(raw, np.int64)
    n = keys.shape[0]
    data = {"k": keys, "v": np.arange(n, dtype=np.float32)}
    jp, jh = jdr.device_partition_ids(keys, m)
    tp, th = tdr.device_partition_ids(keys, m, device="cpu")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    counts = th.numpy().astype(np.int64) if n else np.zeros(m, np.int64)
    want = jdr.device_scatter_padded(data, jp, counts)
    got = tdr.device_scatter_padded(data, tp, counts, mode="fused",
                                    device="cpu")
    for k in data:
        _same(got[k], want[k], k)


@given(st.integers(1, 24),
       st.lists(st.integers(0, 23), min_size=1, max_size=300))
@settings(max_examples=25, deadline=None)
def test_scatter_perm_equals_the_pallas_kernel(m, pid_list):
    """The port's CPU route of ``scatter_perm`` against the reference's
    Pallas kernel (interpret mode), for any pid multiset."""
    pids = np.array(pid_list, np.int32) % m
    counts = np.bincount(pids, minlength=m).astype(np.int32)
    want = scatter_perm(jnp.asarray(pids), jnp.asarray(counts), block=64,
                        interpret=True)
    got = ops.scatter_permutation(torch.from_numpy(pids),
                                  torch.from_numpy(counts))
    _same(got, want, "dest")


@given(st.lists(st.integers(0, 2 ** 31 - 1), min_size=1, max_size=200),
       st.integers(2, 16))
@settings(max_examples=20, deadline=None)
def test_d2d_repartition_equals_reference(raw, m):
    """A round-robin device store repartitioned d2d on the CPU route ≡ the
    reference's host repartition: counts and gathered rows."""
    keys = np.array(raw, np.int64)
    data = {"author": keys,
            "score": np.arange(keys.size, dtype=np.float32)}
    jcand = j_enumerate(j_author().graph, "submissions")[0]
    cand = enumerate_candidates(author_integrator().graph, "submissions")[0]
    host = JStore(m)
    want, _ = host.repartition(host.write("submissions", data), jcand)
    dev = PartitionStore(m, backend="device", device="cpu")
    got, _ = dev.repartition(dev.write("submissions", data), cand)
    np.testing.assert_array_equal(got.counts, want.counts)
    fw, fg = want.gather(), got.gather()
    assert set(fg) == set(fw)
    for k in fw:
        _same(fg[k], fw[k], k)
