"""The reference's hypothesis sweeps of skew-adaptive layouts
(``tests/test_skew_properties.py``, DESIGN §12) held against the port.

Each draw feeds the same numpy arrays to the JAX package and to the
port's CPU route: a bucketed (capacity-map) scatter must equal the
reference's bit for bit and hold the same rows as the uniform layout, and
an adaptive store's gather must equal the reference's and the uniform
store's, through the host and the d2d write routes, for any keys,
arbitrary skew and zero-capacity buckets.  ``max_examples`` are the
reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import author_integrator as j_author  # noqa: E402
from repro.core import enumerate_candidates as j_enumerate  # noqa: E402
from repro.data import device_repartition as jdr  # noqa: E402
from repro.data.capacity import CapacityMap as JCapacityMap  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro.data.skew import zipf_keys  # noqa: E402
from repro_torch.core import author_integrator, enumerate_candidates  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.data.capacity import CapacityMap, valid_slot_index  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402
from repro_torch.data.skew import zipf_keys as t_zipf_keys  # noqa: E402

PAYLOAD_DTYPES = (np.float32, np.int32, np.float64, np.int64)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@given(st.integers(2, 16),
       st.integers(0, len(PAYLOAD_DTYPES) - 1),
       st.integers(0, 3),                      # key domain exponent → skew
       st.lists(st.integers(0, 2 ** 31 - 1), min_size=1, max_size=300))
@settings(max_examples=20, deadline=None)
def test_bucketed_scatter_equals_reference_and_uniform(m, pdt, dom, raw):
    keys = np.array(raw, np.int64) % (4 ** dom + 1)
    n = keys.shape[0]
    data = {"k": keys,
            "v": (np.arange(n) * 3).astype(PAYLOAD_DTYPES[pdt]),
            "mat": np.arange(2 * n, dtype=np.float32).reshape(n, 2)}
    tp, th = tdr.device_partition_ids(keys, m, device="cpu")
    jp, _ = jdr.device_partition_ids(keys, m)
    counts = th.numpy().astype(np.int64)
    cmap = CapacityMap.from_counts(counts)     # zero-capacity buckets too
    jmap = JCapacityMap.from_counts(counts)
    np.testing.assert_array_equal(cmap.offsets, jmap.offsets)
    uni = tdr.device_scatter_padded(data, tp, counts, device="cpu")
    buck = tdr.device_scatter_padded(data, tp, counts, capacity_map=cmap,
                                     device="cpu")
    want = jdr.device_scatter_padded(data, jp, counts, capacity_map=jmap)
    cap = int(counts.max())
    vidx_u = valid_slot_index(counts, np.arange(m, dtype=np.int64) * cap)
    vidx_b = valid_slot_index(counts, cmap.offsets)
    for k, v in data.items():
        got_b, want_b = _np(buck[k]), np.asarray(want[k])
        assert got_b.dtype == want_b.dtype == v.dtype, k
        np.testing.assert_array_equal(got_b, want_b, err_msg=k)
        got_u = _np(uni[k]).reshape((m * cap,) + v.shape[1:])[vidx_u]
        np.testing.assert_array_equal(got_u, got_b[vidx_b], err_msg=k)


@given(st.integers(2, 8), st.floats(1.05, 2.5),
       st.integers(40, 300), st.booleans())
@settings(max_examples=15, deadline=None)
def test_adaptive_store_gather_equals_reference_and_uniform(m, alpha, n,
                                                           device):
    """The same keyed write through an adaptive store and a plain one, in
    both packages (host path or d2d path): identical counts and flat
    rows, 64-bit columns included."""
    keys = zipf_keys(n, n, alpha, seed=7)
    np.testing.assert_array_equal(t_zipf_keys(n, n, alpha, seed=7), keys)
    cols = {"author": keys,
            "v64": np.arange(n, dtype=np.int64),
            "v32": np.arange(n, dtype=np.float32)}
    cand = enumerate_candidates(author_integrator().graph, "submissions")[0]
    jcand = j_enumerate(j_author().graph, "submissions")[0]
    backend = "device" if device else "host"
    out = {}
    for adaptive in (False, True):
        ds = PartitionStore(m, backend=backend, device="cpu",
                            adaptive_capacity=adaptive).write(
            "submissions", cols, cand)
        jds = JStore(m, backend=backend, adaptive_capacity=adaptive).write(
            "submissions", cols, jcand)
        np.testing.assert_array_equal(ds.counts, jds.counts)
        assert (ds.capacity_map is None) == (jds.capacity_map is None)
        out[adaptive] = (ds, ds.gather(), jds.gather())
    assert out[False][0].capacity_map is None
    np.testing.assert_array_equal(out[False][0].counts, out[True][0].counts)
    for k in cols:
        for flat in (out[False][1], out[True][1], out[True][2]):
            assert flat[k].dtype == out[False][2][k].dtype, k
            np.testing.assert_array_equal(np.asarray(flat[k]),
                                          np.asarray(out[False][2][k]),
                                          err_msg=k)
