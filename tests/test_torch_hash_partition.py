"""Hash-partition kernels of the torch port against the JAX package.

The plain torch versions (what a CPU tensor runs) must be bit-equal to the
Pallas kernels (interpret mode) and to the jnp oracles on pids, counts and
destinations.  (The CUDA kernels against the plain versions are in
``test_torch_cuda.py``.)  Inputs are made with numpy from a seed and handed
to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.ir import _mix_hash as jax_mix_hash  # noqa: E402
from repro.data import device_repartition as jdr  # noqa: E402
from repro.kernels.hash_partition import hash_partition as jk  # noqa: E402
from repro.kernels.hash_partition import ref as jref  # noqa: E402
from repro_torch.core.ir import _mix_hash  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as tk  # noqa: E402
from repro_torch.kernels.hash_partition import ops  # noqa: E402
from repro_torch.kernels.hash_partition import ref as tref  # noqa: E402


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2 ** 31 - 1, n,
                                                dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- plain versions against the Pallas kernels and jnp oracles ---------------

@pytest.mark.parametrize("n,m,block", [(1000, 8, 512), (4096, 16, 1024),
                                       (5000, 7, 512), (64, 4, 64),
                                       (10_000, 256, 2048)])
def test_hash_partition_twin_matches_pallas(n, m, block):
    keys = _keys(n)
    kp, kc = jk.hash_partition(jnp.asarray(keys), m, block=block,
                               interpret=True)
    rp, rc = jref.hash_partition_ref(jnp.asarray(keys), m)
    tp, tc = ops.partition_ids(_t(keys), m)
    assert tp.dtype == torch.int32 and tc.dtype == torch.int32
    for want_p, want_c in ((kp, kc), (rp, rc)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("n,m,block", [(100, 8, 64), (1000, 13, 256),
                                       (7, 4, 8), (4096, 32, 1024)])
def test_scatter_perm_twin_matches_pallas(n, m, block):
    keys = _keys(n, seed=1)
    pids, counts = jref.hash_partition_ref(jnp.asarray(keys), m)
    got = jk.scatter_perm(pids, counts, block=block, interpret=True)
    want = jref.scatter_perm_ref(pids, counts)
    dest = ops.scatter_permutation(_t(np.asarray(pids)),
                                   _t(np.asarray(counts)))
    assert dest.dtype == torch.int32
    np.testing.assert_array_equal(dest.numpy(), np.asarray(got))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want))
    assert np.array_equal(np.sort(dest.numpy()), np.arange(n))


def test_scatter_perm_twin_is_stable_counting_sort():
    pids = np.array([2, 0, 2, 1, 0, 2, 0], np.int32)
    counts = np.bincount(pids, minlength=3).astype(np.int32)
    dest = ops.scatter_permutation(_t(pids), _t(counts)).numpy()
    pallas = np.asarray(jk.scatter_perm(jnp.asarray(pids),
                                        jnp.asarray(counts), block=8,
                                        interpret=True))
    order = np.argsort(pids, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    np.testing.assert_array_equal(dest, inv)
    np.testing.assert_array_equal(dest, pallas)


def test_scatter_perm_twin_ignores_high_sentinels():
    """Pids at or above the bin count (the padded overflow partition and
    beyond) never move a real row: in-range rows match the Pallas kernel."""
    rng = np.random.default_rng(9)
    m = 5
    pids = rng.integers(0, m, 300).astype(np.int32)
    pids[rng.integers(0, 300, 40)] = m + 3
    counts = np.bincount(pids[pids < m], minlength=m).astype(np.int32)
    dest = ops.scatter_permutation(_t(pids), _t(counts)).numpy()
    pallas = np.asarray(jk.scatter_perm(jnp.asarray(pids),
                                        jnp.asarray(counts), block=64,
                                        interpret=True))
    real = pids < m
    np.testing.assert_array_equal(dest[real], pallas[real])


@pytest.mark.parametrize("n,B,m", [(100, 128, 8), (1000, 1024, 13),
                                   (8, 8, 4), (5000, 8192, 32)])
def test_hash_partition_padded_twin_matches_pallas(n, B, m):
    keys = _keys(B, seed=2)
    kp, kc = jk.hash_partition_padded(jnp.asarray(keys), jnp.int32(n), m,
                                      block=256, interpret=True)
    rp, rc = jref.hash_partition_padded_ref(jnp.asarray(keys), jnp.int32(n),
                                            m)
    tp, tc = ops.padded_partition_ids(_t(keys), n, m)
    for want_p, want_c in ((kp, kc), (rp, rc)):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(want_c))
    assert int(tc[m]) == B - n and int(tc[:m].sum()) == n


@pytest.mark.parametrize("m", [1, 4, 256])
def test_empty_keys(m):
    jp, jc = jdr.device_partition_ids(np.zeros(0, np.int64), m)
    tp, tc = tdr.device_partition_ids(np.zeros(0, np.int64), m,
                                      device="cpu")
    assert tp.shape == (0,) and np.asarray(jp).shape == (0,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    dest = ops.scatter_permutation(tp, torch.zeros(m, dtype=torch.int32))
    assert dest.shape == (0,)


def _key_cases():
    rng = np.random.default_rng(13)
    return {
        "int64_wide": rng.integers(2 ** 31, 2 ** 40, 257, dtype=np.int64),
        "int64_negative": rng.integers(-2 ** 40, 0, 257, dtype=np.int64),
        "int32": rng.integers(-2 ** 31, 2 ** 31 - 1, 257).astype(np.int32),
        "float32": rng.normal(size=257).astype(np.float32),
        "float64": rng.normal(size=257) * 1e6,
        "bool": rng.integers(0, 2, 257).astype(bool),
        "uint8": rng.integers(0, 256, 257).astype(np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_key_cases()))
@pytest.mark.parametrize("m", [16, 256])
def test_key_normalization_matches_reference(case, m):
    """as_kernel_keys / _host_kernel_keys / _mix_hash keep the reference's
    dtype rules: int64 wraps, float32 bits are viewed, float64 rounds to
    float32 first, everything else casts to int32."""
    keys = _key_cases()[case]
    jp, jc = jdr.device_partition_ids(keys, m)
    tp, tc = tdr.device_partition_ids(keys, m, device="cpu")
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the same keys arriving as a torch tensor on the device
    tp2, _ = tdr.device_partition_ids(_t(keys), m)
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tdr._host_kernel_keys(keys),
                                  jdr._host_kernel_keys(keys))
    want = np.asarray(jax_mix_hash(keys)).astype(np.int64)
    np.testing.assert_array_equal(_mix_hash(keys).numpy(), want)
    np.testing.assert_array_equal(_mix_hash(_t(keys)).numpy(), want)
    for mode in ("fused", "hostperm"):
        sp, sc = tdr.shuffle_pids(keys, m, mode=mode, device="cpu")
        jsp, jsc = jdr.shuffle_pids(keys, m, mode="hostperm")
        np.testing.assert_array_equal(np.asarray(sp), np.asarray(jsp))
        np.testing.assert_array_equal(sc, jsc)


def test_wang_hash_twin_matches_jnp():
    x = np.random.default_rng(4).integers(-2 ** 31, 2 ** 31 - 1, 4096) \
        .astype(np.int32)
    want = np.asarray(jref.wang_hash(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tref.wang_hash(_t(x)).numpy(), want)


def test_kernel_wrappers_reject_cpu_tensors():
    """The CUDA launchers never run a plain version: a CPU tensor is an
    error there (ops is what routes CPU tensors to the plain versions)."""
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tk.hash_partition(keys, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tk.hash_partition_padded(keys, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tk.scatter_perm(keys, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="no hash-partition path"):
        ops.partition_ids(torch.zeros(8, dtype=torch.int32, device="meta"), 4)
