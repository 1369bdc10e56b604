"""Card-only cases of the torch port: the hand-written CUDA kernels against
their plain torch versions, and the device session against the host one.

Every case carries the ``cuda`` marker and skips where no card is present
(the decision is taken inside the fixture, so every pytest worker collects
the same tests).  This file imports torch and the port only — no JAX — so
it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import os

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


def _scatter_pids(cuda, n, bins, case, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + n + bins)
    pids = torch.randint(0, bins, (n,), dtype=torch.int32, device=cuda,
                         generator=g)
    if case == "one_bin":
        pids.fill_(bins // 2)
    elif case == "skewed":          # half the rows in one bin
        half = torch.rand(n, device=cuda, generator=g) < 0.5
        pids[half] = min(3, bins - 1)
    counts = torch.bincount(pids, minlength=bins).to(torch.int32)
    return pids, counts


SCATTER_BINS = [1, 33, 257, tk.SCATTER_SINGLE_PASS_MAX_BINS,
                tk.SCATTER_SINGLE_PASS_MAX_BINS + 1, 4097]


@pytest.mark.parametrize("case", ["uniform", "one_bin", "skewed"])
@pytest.mark.parametrize("bins", SCATTER_BINS)
def test_cuda_scatter_perm_routes_match_twin(cuda, bins, case):
    """Both routes, on both sides of the bin threshold, at 2^22 rows."""
    pids, counts = _scatter_pids(cuda, 1 << 22, bins, case)
    tk.reset_launches()
    dest = tk.scatter_perm(pids, counts)
    torch.cuda.synchronize()
    assert torch.equal(dest, tref.scatter_perm_ref(pids, counts))
    assert tk.SCATTER_ROUTES[tk.scatter_route(bins)] == 1
    assert tk.LAUNCHES["scatter_perm"] == 1


@pytest.mark.parametrize("bins", [33, tk.SCATTER_SINGLE_PASS_MAX_BINS,
                                  tk.SCATTER_SINGLE_PASS_MAX_BINS + 1])
def test_cuda_scatter_perm_tile_edges(cuda, bins):
    T = tk.SCATTER_TILE_ROWS
    for n in (1, 31, T - 1, T, T + 1, 5 * T + 7):
        pids, counts = _scatter_pids(cuda, n, bins, "uniform")
        dest = tk.scatter_perm(pids, counts)
        torch.cuda.synchronize()
        assert torch.equal(dest, tref.scatter_perm_ref(pids, counts)), n


def test_cuda_scatter_perm_unaligned_view_and_sentinels(cuda):
    """A view one element off (no 16-B loads) and sentinel pids -1 and
    >= bins: real rows keep their places, sentinel rows get 0."""
    for bins in (33, 257):
        _check_unaligned_view_and_sentinels(cuda, bins)


def _check_unaligned_view_and_sentinels(cuda, bins):
    n = 5 * tk.SCATTER_TILE_ROWS + 7
    pids, _ = _scatter_pids(cuda, n + 1, bins, "uniform")
    pids[::97] = -1
    pids[5::89] = bins + 4
    view = pids[1:]
    real = (view >= 0) & (view < bins)
    counts = torch.bincount(view[real], minlength=bins).to(torch.int32)
    dest = tk.scatter_perm(view, counts)
    want = tref.scatter_perm_ref(torch.where(real, view, bins), counts)
    torch.cuda.synchronize()
    assert torch.equal(dest[real], want[real])
    assert not bool(dest[~real].any())


def test_cuda_scatter_perm_is_deterministic(cuda):
    """Ten launches on one input are bit-equal: a look-back race would
    show as a launch that differs."""
    pids, counts = _scatter_pids(cuda, 1 << 22, 33, "skewed", seed=1)
    first = tk.scatter_perm(pids, counts)
    for _ in range(9):
        assert torch.equal(tk.scatter_perm(pids, counts), first)
    assert torch.equal(first, tref.scatter_perm_ref(pids, counts))


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
    assert tk.SCATTER_ROUTES["single_pass"] == tk.LAUNCHES["scatter_perm"]
    assert tk.LAUNCHES["hash_partition"] > 0
    if not partitioned:
        assert tk.LAUNCHES["hash_partition_padded"] > 0


# -- the durable store on the card -----------------------------------------------

def _segment_bytes(root):
    out = {}
    base = os.path.join(root, "datasets")
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".seg"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), base)] = \
                        fh.read()
    return out


def test_cuda_durable_write_reopens_bit_equal_to_host(cuda, tmp_path):
    """A device store's segments equal the host store's byte for byte, and
    a reopened device store prefetches them back to the card on read."""
    tables = _reddit()
    wl = tcore.author_integrator()
    cand = tcore.enumerate_candidates(wl.graph, "submissions")[0]
    roots = {b: str(tmp_path / b) for b in ("device", "host")}
    for backend, root in roots.items():
        sess = lachesis_torch.Session(num_workers=16, backend=backend,
                                      store_path=root)
        sess.write("submissions", tables["submissions"], cand)
        sess.write("authors", tables["authors"])
    dev, host = _segment_bytes(roots["device"]), _segment_bytes(roots["host"])
    assert sorted(dev) == sorted(host) and dev
    for rel in host:
        assert dev[rel] == host[rel], rel
    again = lachesis_torch.Session(backend="device", store_path=roots["device"])
    assert again.store.datasets["submissions"].spilled
    got = again.read("submissions")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cuda"
               for v in got.columns.values())
    ref = lachesis_torch.Session(backend="host", store_path=roots["host"])
    want = ref.read("submissions").gather()
    for k, v in got.gather().items():
        np.testing.assert_array_equal(v, want[k])
    res = again.run(wl)
    assert res.stats.shuffles_elided == 1


def test_cuda_spill_frees_memory_and_prefetch_returns_cuda(cuda, tmp_path):
    root = str(tmp_path / "store")
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(0, 1 << 20, 1 << 20),
            "v": rng.normal(size=1 << 20).astype(np.float32)}
    wl = tcore.Workload("w")
    wl.partition(wl.scan("d")["k"])
    cand = tcore.enumerate_candidates(wl.graph, "d")[0]
    sess = lachesis_torch.Session(num_workers=32, store_path=root)
    ds = sess.write("d", data, cand)
    before = {k: v.clone() for k, v in ds.columns.items()}
    padded = ds.padded_bytes
    del ds
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    assert sess.store.spill("d")
    assert held - torch.cuda.memory_allocated() >= padded
    assert sess.store.resident_bytes() == 0
    got = sess.read("d")                     # prefetch host→device
    assert not got.spilled
    for k, v in got.columns.items():
        assert v.device.type == "cuda"
        assert torch.equal(v, before[k])
    assert sess.store.io_snapshot()["rehydrations"] == 1


# -- LM serving path: flash attention and the chunked SSD scan ------------------

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

FA_SHAPES = [
    # (B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype)
    (1, 4, 2, 256, 256, 64, True, None, 0.0, torch.float32),
    (2, 4, 4, 100, 100, 32, True, 64, 0.0, torch.float32),
    (1, 2, 1, 70, 192, 64, False, None, 0.0, torch.float32),
    (1, 2, 2, 320, 320, 128, True, 128, 50.0, torch.float32),
    (1, 2, 2, 130, 130, 256, True, None, 0.0, torch.bfloat16),
    (2, 8, 2, 384, 384, 128, True, None, 0.0, torch.bfloat16),
    # the bf16 tensor-core kernel: window, softcap, kv tail, MQA, Sq != Skv,
    # hd 32 and 256
    (2, 4, 4, 128, 128, 32, True, 64, 0.0, torch.bfloat16),
    (1, 4, 2, 256, 256, 64, True, None, 30.0, torch.bfloat16),
    (1, 2, 2, 320, 320, 128, True, 128, 50.0, torch.bfloat16),
    (1, 2, 2, 320, 320, 128, True, 80, 0.0, torch.bfloat16),
    (1, 4, 2, 70, 200, 128, False, None, 0.0, torch.bfloat16),
    (1, 2, 1, 192, 192, 64, False, None, 0.0, torch.bfloat16),
    (1, 2, 1, 70, 192, 64, False, None, 0.0, torch.bfloat16),
    (2, 4, 4, 100, 100, 32, True, 64, 0.0, torch.bfloat16),
    (1, 2, 2, 192, 192, 256, True, 100, 20.0, torch.bfloat16),
    # the RG-LRU and encoder configs' prefill shapes: recurrentgemma-9b's
    # local layer (MQA, group 16, hd 256, window 2048 at a 4096 prompt),
    # whisper-small's encoder (non-causal, 1500 frames: a partial last kv
    # tile) and its cross-attention (224 queries over 1500 frames)
    (4, 16, 1, 4096, 4096, 256, True, 2048, 0.0, torch.float32),
    (4, 16, 1, 4096, 4096, 256, True, 2048, 0.0, torch.bfloat16),
    (8, 12, 12, 1500, 1500, 64, False, None, 0.0, torch.float32),
    (8, 12, 12, 1500, 1500, 64, False, None, 0.0, torch.bfloat16),
    (8, 12, 12, 224, 1500, 64, False, None, 0.0, torch.float32),
    (8, 12, 12, 224, 1500, 64, False, None, 0.0, torch.bfloat16),
]


@pytest.mark.parametrize("case", FA_SHAPES)
def test_cuda_flash_attention_matches_twin(cuda, case):
    B, H, KV, Sq, Skv, hd, causal, window, cap, dtype = case
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g, device=cuda).to(dtype)
    # strided (B, H, S, hd) views of (B, S, H, hd) buffers, as the model
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    want = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # relative RMS: bf16 rounding gives ~2e-3, a skipped tile ~1e-1
        err = torch.linalg.vector_norm(got.double() - want.double())
        assert float(err / torch.linalg.vector_norm(want.double())) <= 1e-2


def test_cuda_flash_attention_rejects(cuda):
    q = torch.zeros((1, 4, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), q.half(), q.half())


def test_cuda_flash_attention_rejects_misaligned_bf16(cuda):
    """The bf16 kernel's cp.async loads need 16-B aligned rows: a view one
    element off, or with an odd row stride, raises and is not copied."""
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16, device=cuda)
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-B aligned"):
        fa.flash_attention(off, q[:, :2], q[:, :2])
    odd = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16,
                      device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-B aligned"):
        fa.flash_attention(q, odd, odd)
    fa.flash_attention(q, q[:, :2], q[:, :2])      # aligned views pass


SSD_SHAPES = [
    # (B, T, H, P, N, chunk, dtype)
    (2, 128, 4, 32, 64, 32, torch.float32),
    (1, 256, 8, 64, 128, 64, torch.float32),
    (1, 128, 2, 16, 32, 16, torch.bfloat16),
    (2, 512, 4, 64, 128, 256, torch.bfloat16),
]


def _ssd_inputs(cuda, B, T, H, P, N, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + P + N)
    x = (torch.randn((B, T, H, P), generator=g, device=cuda) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=g, device=cuda) * 0.3)
    Bm = (torch.randn((B, T, N), generator=g, device=cuda) * 0.3).to(dtype)
    Cm = (torch.randn((B, T, N), generator=g, device=cuda) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("case", SSD_SHAPES)
def test_cuda_ssd_scan_matches_twin(cuda, case):
    B, T, H, P, N, chunk, dtype = case
    args = _ssd_inputs(cuda, B, T, H, P, N, dtype)
    y, st = ss.ssd_scan(*args, chunk)
    yr, str_ = ssd_ref(*args, chunk)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st.float(), str_.float(), atol=tol, rtol=tol)


def _ssd_slow_inputs(cuda, B, T, H, P, N, dtype):
    """Mamba-2's published init (dt log-uniform in [1e-3, 1e-1], A =
    -U(1, 16)): slow decay, so every key tile of a chunk reaches its later
    rows, and x, B and C as slices of one (B, T, H*P + 2N) buffer, as the
    model's convolution output hands them over."""
    g = torch.Generator(device=cuda).manual_seed(T + P + N + 1)
    conv = torch.randn((B, T, H * P + 2 * N), generator=g, device=cuda)
    conv[..., :H * P] *= 0.5
    conv[..., H * P:] *= 0.3
    conv = conv.to(dtype)
    x = conv[..., :H * P].reshape(B, T, H, P)
    dt = torch.exp(torch.empty((B, T, H), device=cuda).uniform_(
        np.log(1e-3), np.log(1e-1), generator=g))
    A = -torch.empty((H,), device=cuda).uniform_(1.0, 16.0, generator=g)
    return x, dt, A, conv[..., H * P:H * P + N], conv[..., H * P + N:]


# the SSD shapes, then the bf16 kernel's odd widths and mamba2's widths
SSD_SLOW_SHAPES = SSD_SHAPES + [
    (1, 256, 2, 32, 64, 32, torch.bfloat16),
    (2, 192, 2, 48, 80, 64, torch.bfloat16),
    (1, 1024, 16, 64, 128, 256, torch.bfloat16),
]


@pytest.mark.parametrize("case", SSD_SLOW_SHAPES)
def test_cuda_ssd_scan_slow_decay_matches_twin(cuda, case):
    """Slow decay makes every tile pair of the kernel count; bf16 is also
    held to 1e-2 relative RMS (rounding gives ~3e-3, a dropped adjacent
    key tile ~1e-1)."""
    B, T, H, P, N, chunk, dtype = case
    args = _ssd_slow_inputs(cuda, B, T, H, P, N, dtype)
    y, st = ss.ssd_scan(*args, chunk)
    yr, str_ = ssd_ref(*args, chunk)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st.float(), str_.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        for got, want in ((y, yr), (st, str_)):
            err = torch.linalg.vector_norm(got.double() - want.double())
            assert float(err / torch.linalg.vector_norm(want.double())) \
                <= 1e-2


def test_cuda_ssd_scan_rejects_misaligned_bf16(cuda):
    """The bf16 kernel's cp.async loads need 16-B aligned rows."""
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, 1, 32, 2, 16, 32, torch.bfloat16)
    off = torch.zeros(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-B aligned"):
        ss.ssd_scan(off, dt, A, Bm, Cm, 16)
    odd = torch.zeros((1, 32, 36), dtype=torch.bfloat16,
                      device=cuda)[..., :32]
    with pytest.raises(ValueError, match="16-B aligned"):
        ss.ssd_scan(x, dt, A, odd, Cm, 16)
    ss.ssd_scan(x, dt, A, Bm, Cm, 16)          # aligned tensors pass


def test_cuda_ssd_scan_rejects(cuda):
    args = _ssd_inputs(cuda, 1, 48, 2, 16, 32, torch.float32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ss.ssd_scan(*args, 32)
    args = _ssd_inputs(cuda, 1, 32, 2, 80, 32, torch.float32)
    with pytest.raises(ValueError, match="P=80"):
        ss.ssd_scan(*args, 16)
    args = _ssd_inputs(cuda, 1, 32, 2, 16, 144, torch.float32)
    with pytest.raises(ValueError, match="N=144"):
        ss.ssd_scan(*args, 16)


def test_cuda_lm_launch_counters(cuda):
    fa.reset_launches()
    ss.reset_launches()
    q = torch.zeros((1, 2, 16, 32), device=cuda)
    fa.flash_attention(q, q, q)
    ss.ssd_scan(*_ssd_inputs(cuda, 1, 32, 2, 16, 16, torch.float32), 16)
    assert fa.LAUNCHES == {"flash_attention": 1}
    assert ss.LAUNCHES == {"ssd_scan": 1}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-370m",
                                  "chameleon-34b", "llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b", "recurrentgemma-9b",
                                  "whisper-small"])
def test_cuda_reduced_prefill_matches_cpu(cuda, arch):
    """Reduced model (head_dim 32: the kernel takes 32..256), float32:
    prefill and two decode steps on the card equal the same weights on the
    CPU (recurrentgemma's ring caches wrap: prompt 40, window 8), and the
    prefill went through the kernel of its mixer once per attention layer
    (whisper: encoder layers, decoder layers and their cross-attention)."""
    import dataclasses
    cfg = reduced(get_config(arch))
    if cfg.ssd is None:
        cfg = dataclasses.replace(cfg, head_dim=32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dparams = _to_device(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    frames = None
    if cfg.encoder is not None:
        frames = torch.randn((2, cfg.encoder.num_frames, cfg.d_model),
                             generator=torch.Generator().manual_seed(1))
    fa.reset_launches()
    ss.reset_launches()
    with torch.inference_mode():
        want, wcache = TT.prefill(cfg, params, tokens, frames=frames,
                                  cache_len=42)
        got, gcache = TT.prefill(
            cfg, dparams, tokens.to(cuda), cache_len=42,
            frames=None if frames is None else frames.to(cuda))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for i in range(2):
            tok = torch.argmax(want, -1)[:, None].to(torch.int32)
            want, wcache = TT.decode_step(cfg, params, wcache, tok, 40 + i)
            got, gcache = TT.decode_step(cfg, dparams, gcache, tok.to(cuda),
                                         40 + i)
            torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    if cfg.ssd:
        assert ss.LAUNCHES["ssd_scan"] == cfg.num_layers
    else:
        attn = sum(s.mixer in ("attn", "mla") for s in cfg.all_specs)
        if cfg.encoder is not None:
            attn += cfg.encoder.num_layers + cfg.num_layers
        assert fa.LAUNCHES["flash_attention"] == attn


def test_cuda_rglru_block_matches_cpu(cuda):
    """The RG-LRU block at recurrentgemma-9b's width (4096) over a prompt
    of 512 on the card against the CPU, float32: the log-depth scan, its
    state, and decode steps from that state, within 1e-4."""
    from repro_torch.models import rglru as TR
    p = TR.rglru_init(torch.Generator().manual_seed(0), 256, width=4096,
                      conv_width=4, dtype=torch.float32)
    dp = _to_device(p, cuda)
    x = torch.randn((2, 520, 256), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want, wst = TR.rglru_block(p, x[:, :512], return_final_state=True)
        got, gst = TR.rglru_block(dp, x[:, :512].to(cuda),
                                  return_final_state=True)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for t in range(512, 520):
            want, wst = TR.rglru_block(p, x[:, t:t + 1], state=wst)
            got, gst = TR.rglru_block(dp, x[:, t:t + 1].to(cuda), state=gst)
            torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for k in ("h", "conv"):
            torch.testing.assert_close(gst[k].cpu(), wst[k], atol=1e-4,
                                       rtol=1e-4)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# -- the service slice: Autopilot, rebucket and the serving frontend ----------

def _same_cols(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        w = want[k].cpu().numpy() if isinstance(want[k], torch.Tensor) \
            else np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_cuda_drift_scenario_applies_d2d_and_matches_host(cuda):
    from repro_torch.service import run_drift_scenario
    tk.reset_launches()
    dev = run_drift_scenario()                     # the card by default
    launched = dict(tk.LAUNCHES)
    host = run_drift_scenario(backend="host")
    for tick in (dev.tick_a, dev.tick_b):
        assert "lineitem" in {a.dataset for a in tick.applied}
        assert {a.path for a in tick.applied} == {"d2d"}
    assert dev.lineitem_generations == host.lineitem_generations == [0, 1, 2]
    assert dev.lineitem_partitioners == host.lineitem_partitioners
    for f in ("result_pre_a", "result_post_a", "result_pre_b",
              "result_post_b"):
        _same_cols(getattr(dev, f), getattr(host, f))
    for name in ("lineitem", "orders"):
        ds = dev.store.read(name)
        assert ds.columns["orderkey"].device.type == "cuda"
        _same_cols(ds.columns, host.store.read(name).columns)
    assert launched["hash_partition"] >= 3 and launched["scatter_perm"] > 0


@pytest.mark.parametrize("adaptive", [False, True])
def test_cuda_mesh_of_four_positions_matches_cpu(cuda, adaptive):
    """A dataset placed on a 4-position mesh over the card and repartitioned
    shard to shard equals the same on ``Mesh(["cpu"] * 4)``, shard for
    shard; the uniform path launches one hash and two scatters per shard
    and reads no column whole; an adaptive store over Zipf keys buckets
    the result, replicated at every position."""
    from repro_torch.core.sharding_bridge import (WHOLE_READS, Mesh,
                                                  device_put_dataset,
                                                  reset_whole_reads)
    rng = np.random.default_rng(16)
    n = 200_000
    pk = rng.integers(0, 5_000, n)
    if adaptive:
        pk = np.minimum(rng.zipf(1.3, n), 100_000) - 1
    data = {"orderkey": rng.integers(0, 50_000, n), "partkey": pk,
            "qty": rng.integers(1, 50, n).astype(np.float32),
            "vec": rng.normal(size=(n, 2)).astype(np.float32)}
    wl = lachesis_torch.Workload("mesh")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    got = {}
    for dev in ("cuda", "cpu"):
        store = lachesis_torch.Session(num_workers=8, device=dev,
                                       adaptive_capacity=adaptive).store
        mesh = Mesh([dev] * 4, ("data",))
        placed = device_put_dataset(
            mesh, store.write("lineitem", data, by_order))
        tk.reset_launches()
        reset_whole_reads()
        new, _ = store.repartition(placed, by_part, mesh=mesh)
        store.synchronize()
        got[dev] = (new, dict(tk.LAUNCHES), WHOLE_READS["columns"])
    (card, launched, reads), (cpu, _, _) = got["cuda"], got["cpu"]
    np.testing.assert_array_equal(card.counts, cpu.counts)
    assert (card.capacity_map is not None) == adaptive
    for k, col in cpu.columns.items():
        ours = list(card.columns[k].shards())
        assert [s[:1] + s[2:3] for s in ours] == \
            [s[:1] + s[2:3] for s in col.shards()]
        for (_, d, _, t), (_, _, _, w) in zip(ours, col.shards()):
            assert d.type == "cuda" and t.device.type == "cuda"
            np.testing.assert_array_equal(t.cpu().numpy(), w.numpy(),
                                          err_msg=k)
    if adaptive:
        assert reads == len(cpu.columns)
        assert launched["hash_partition"] == 4
    else:
        assert reads == 0
        assert launched == {"hash_partition": 4, "hash_partition_padded": 0,
                            "scatter_perm": 8}


def test_cuda_rebucket_stays_on_the_card_and_matches_host(cuda, monkeypatch):
    from repro_torch.data.partition_store import PartitionStore, StoredDataset
    from repro_torch.service import drift_tables, q_orderkey
    tables = drift_tables(n_lineitem=20_000, skew=1.5, seed=2)
    cand = tcore.enumerate_candidates(q_orderkey().graph, "lineitem")[0]
    dev = PartitionStore(8, backend="device", device="cuda")
    host = PartitionStore(8, backend="host")
    dev.write("lineitem", tables["lineitem"], cand)
    host.write("lineitem", tables["lineitem"], cand)

    def no_host_gather(self):
        raise AssertionError("rebucket gathered to the host")
    monkeypatch.setattr(StoredDataset, "gather", no_host_gather)
    tk.reset_launches()
    dnew, _ = dev.rebucket("lineitem")
    assert tk.LAUNCHES["scatter_perm"] >= 1
    monkeypatch.undo()
    hnew, _ = host.rebucket("lineitem")
    assert dnew.capacity_map is not None and dnew.generation == 1
    np.testing.assert_array_equal(dnew.capacity_map.capacities,
                                  hnew.capacity_map.capacities)
    assert all(v.device.type == "cuda" for v in dnew.columns.values())
    _same_cols(dnew.columns, hnew.columns)


def test_cuda_frontend_eight_clients_equal_serial(cuda):
    import threading
    from repro_torch.service import aggregate_result, drift_tables
    sess = lachesis_torch.Session(num_workers=8)
    for name, data in drift_tables(n_lineitem=50_000, n_orders=5000,
                                   n_parts=500).items():
        sess.write(name, data)

    def q(key):
        wl = tcore.Workload(f"q-{key}")
        li = wl.scan("lineitem")
        other = wl.scan("orders" if key == "orderkey" else "part")
        j = wl.join(li, other, left_key=li[key], right_key=other[key],
                    tag=key)
        wl.aggregate(j, key=j["odate" if key == "orderkey" else "size"],
                     reducer="sum")
        return wl

    want = {k: aggregate_result(sess.run(q(k)).values, q(k))
            for k in ("orderkey", "partkey")}
    errors = []
    tk.reset_launches()
    with sess.serve(max_workers=8, max_queue=64) as front:
        def client(cid):
            try:
                for j in range(3):
                    key = ("orderkey", "partkey")[(cid + j) % 2]
                    res = front.run(q(key), coalesce=False, timeout=120,
                                    block=True)
                    _same_cols(aggregate_result(res.values, q(key)),
                               want[key])
            except Exception as e:              # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        st = front.stats()
    assert not errors, errors[:2]
    assert st["completed"] == 24 and st["failed"] == 0
    # every serve re-buckets each of its 3 partition nodes on the card
    assert tk.LAUNCHES["hash_partition_padded"] == 24 * 3
    assert tk.LAUNCHES["scatter_perm"] == 24 * 3


def test_cuda_apply_wall_covers_its_device_time(cuda, monkeypatch):
    """The Autopilot's apply wall (which calibrates the what-if model)
    is read after the store synchronizes, so it is never smaller than the
    CUDA-event time of the repartition it timed."""
    from repro_torch.data.partition_store import PartitionStore
    from repro_torch.service import (AutopilotConfig, LogicalClock,
                                     drift_tables, q_orderkey)
    store = PartitionStore(8, backend="device", device="cuda")
    for name, data in drift_tables(n_lineitem=2_000_000, n_orders=200_000,
                                   n_parts=2000).items():
        store.write(name, data)
    sess = lachesis_torch.Session(store)
    ap = sess.autopilot(clock=LogicalClock(),
                        config=AutopilotConfig(hysteresis=0.0))
    for _ in range(2):
        sess.run(q_orderkey())
    events = []
    orig = store.repartition

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out
    monkeypatch.setattr(store, "repartition", timed)
    rep = ap.tick()
    torch.cuda.synchronize()
    assert [a.path for a in rep.applied] == ["d2d", "d2d"]
    for a, (start, end) in zip(rep.applied, events):
        assert a.repartition_wall_s * 1e3 >= start.elapsed_time(end)


# ---------------------------------------------------------------------------
# the cluster tier on the card
# ---------------------------------------------------------------------------

def _cluster_files(root):
    """Every node part, directory and pointer file of a cluster store as
    bytes, and every manifest without its timestamps."""
    import json
    from pathlib import Path
    out = {}
    for f in sorted(Path(root).rglob("*")):
        rel = str(f.relative_to(root))
        if not f.is_file() or rel == "catalog.json" \
                or rel.startswith("telemetry"):
            continue
        if f.name.startswith("manifest-"):
            man = json.loads(f.read_text())
            man.pop("created_at")
            for entry in man["generation_log"]:
                entry.pop("created_at")
            out[rel] = man
        else:
            out[rel] = f.read_bytes()
    return out


def _cluster_pair(tmp_path):
    """The same keyed and round-robin writes into a device cluster store
    and its host twin (4 nodes, replication 2)."""
    from repro_torch.cluster import ClusterConfig
    rng = np.random.default_rng(11)
    n = 1 << 18
    data = {"k": rng.integers(0, 1 << 20, n),
            "v": rng.normal(size=n).astype(np.float32)}
    rr = {"x": rng.integers(0, 1000, n // 2).astype(np.int32)}
    wl = tcore.Workload("w")
    wl.partition(wl.scan("d")["k"])
    cand = tcore.enumerate_candidates(wl.graph, "d")[0]
    roots = {b: str(tmp_path / b) for b in ("device", "host")}
    for backend, root in roots.items():
        sess = lachesis_torch.Session(
            num_workers=32, backend=backend, store_path=root,
            cluster=ClusterConfig(nodes=("n0", "n1", "n2", "n3"),
                                  replication=2))
        sess.write("d", data, cand)
        sess.write("rr", rr)
    return roots, wl


def test_cuda_cluster_store_write_reopen_rebalance_match_host(cuda,
                                                             tmp_path):
    """A device cluster store writes, reopens and rebalances to the same
    bytes on disk as its host twin, and reads back the same rows."""
    roots, _wl = _cluster_pair(tmp_path)
    assert _cluster_files(roots["device"]) == _cluster_files(roots["host"])
    sessions = {b: lachesis_torch.Session(backend=b, store_path=root)
                for b, root in roots.items()}
    results = {b: s.rebalance(add_nodes=("n4",), reason="card")
               for b, s in sessions.items()}
    d, h = results["device"], results["host"]
    assert (d.epoch, d.partitions_moved, d.bytes_moved, d.replica_bytes,
            d.bytes_linked) == (h.epoch, h.partitions_moved, h.bytes_moved,
                                h.replica_bytes, h.bytes_linked)
    assert _cluster_files(roots["device"]) == _cluster_files(roots["host"])
    for name in ("d", "rr"):
        got = sessions["device"].read(name).gather()
        want = sessions["host"].read(name).gather()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_cuda_cluster_reopen_puts_columns_on_the_card(cuda, tmp_path):
    """After a reopen (and after a node's directory is deleted) the
    reassembled columns are CUDA tensors, and the first run re-buckets
    through the kernels on them."""
    import shutil
    roots, _wl = _cluster_pair(tmp_path)
    shutil.rmtree(os.path.join(roots["device"], "nodes", "n1"))
    sess = lachesis_torch.Session(store_path=roots["device"])
    host = lachesis_torch.Session(backend="host", store_path=roots["host"])
    for name in ("d", "rr"):
        ds = sess.read(name)
        assert ds.backend == "device"
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cuda"
                   for v in ds.columns.values())
        got, want = ds.gather(), host.read(name).gather()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    wl = tcore.Workload("by-x")
    wl.aggregate(wl.partition(wl.scan("rr")["x"]), reducer="sum")
    tk.reset_launches()
    res = sess.run(wl)
    torch.cuda.synchronize()
    assert res.stats.device_repartitions == 1
    assert tk.LAUNCHES["hash_partition_padded"] == 1
    assert tk.LAUNCHES["scatter_perm"] == 1


def test_cuda_traced_repartition_span_covers_its_cuda_events(
        cuda, monkeypatch):
    """With tracing on, ``store.repartition`` closes after the device work
    it wraps: its span lasts at least as long as the CUDA events around
    the d2d shuffle inside it."""
    from repro_torch import obs
    from repro_torch.data import partition_store as tps
    from repro_torch.data.partition_store import PartitionStore
    events = []
    orig = tps.device_repartition_dataset

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out
    monkeypatch.setattr(tps, "device_repartition_dataset", timed)
    rng = np.random.default_rng(5)
    n = 1 << 22
    store = PartitionStore(32, backend="device", device="cuda")
    ds = store.write("d", {"k": rng.integers(0, 1 << 30, n),
                           "v": rng.normal(size=n).astype(np.float32)})
    wl = tcore.Workload("w")
    wl.partition(wl.scan("d")["k"])
    cand = tcore.enumerate_candidates(wl.graph, "d")[0]
    obs.clear_spans()
    obs.enable("full")
    try:
        torch.cuda.synchronize()
        store.repartition(ds, cand, swap=True)
        (sp,) = [s for s in obs.finished_spans()
                 if s.name == "store.repartition"]
        assert sp.args["path"] == "d2d"
        ((start, end),) = events
        assert sp.dur_s * 1e3 >= start.elapsed_time(end)
        writes = [s for s in obs.finished_spans() if s.name == "store.write"]
        assert writes == []
    finally:
        obs.disable()
        obs.clear_spans()


# -- the training slice: gradients through the kernels, the A3C agent -----------

from repro_torch import tree  # noqa: E402
from repro_torch.core.drl import agent as drl_agent  # noqa: E402
from repro_torch.core.drl import env as drl_env  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ss_ops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402


def _vjp_close(got, want):
    """The Function's backward recomputes the plain twin at the same
    inputs: the same computation, so only a run-to-run reduction order
    could separate them."""
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(b.abs().max() > 0)
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_gradient_is_the_twins_vjp(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    ins = [torch.randn(shape, generator=g, device=cuda).to(dtype)
           .requires_grad_() for shape in ((2, 4, 80, 32), (2, 2, 80, 32),
                                           (2, 2, 80, 32))]
    fa.reset_launches()
    out = fa_ops.attention(*ins, causal=True, window=24)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    got = torch.autograd.grad(out, ins, cot)
    want = torch.autograd.grad(attention_ref(*ins, causal=True, window=24),
                               ins, cot)
    _vjp_close(got, want)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.RECOMPUTES["flash_attention"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_gradient_is_the_twins_vjp(cuda, dtype):
    ins = [t.detach().requires_grad_()
           for t in _ssd_inputs(cuda, 2, 64, 3, 16, 16, dtype)]
    ss.reset_launches()
    y, h = ss_ops.ssd(*ins, chunk=32)
    assert y.grad_fn is not None and h.grad_fn is not None
    g = torch.Generator(device=cuda).manual_seed(4)
    cots = [torch.randn(t.shape, generator=g, device=cuda).to(t.dtype)
            for t in (y, h)]
    got = torch.autograd.grad((y, h), ins, cots)
    want = torch.autograd.grad(ssd_ref(*ins, 32), ins, cots)
    _vjp_close(got, want)
    assert (ss.LAUNCHES["ssd_scan"], ss.RECOMPUTES["ssd_scan"]) == (1, 1)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-370m"])
def test_cuda_train_forward_gives_kernel_only_leaves_gradients(cuda, arch):
    """A CUDA ``forward(mode="train")`` through the kernels: ``wq`` (only
    through flash attention) and ``A_log`` (only through the SSD scan)
    get nonzero gradients, every leaf's gradient is close to the same
    weights' on the CPU (float32: the kernels' forward within 3e-5 and
    1e-4 of the twins'), and each layer launched its kernel twice under
    remat with one backward recompute."""
    import dataclasses
    cfg = reduced(get_config(arch))
    if cfg.ssd is None:
        cfg = dataclasses.replace(cfg, head_dim=32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
    _, _, want = TS.value_and_grad(cfg, params, batch)
    fa.reset_launches()
    ss.reset_launches()
    loss, _, got = TS.value_and_grad(
        cfg, _to_device(params, cuda),
        {k: v.to(cuda) for k, v in batch.items()})
    assert bool(torch.isfinite(loss))
    key = "A_log" if cfg.ssd else "wq"
    for layer in got["layers"]:
        leaf = layer["attn"][key]
        leaf = leaf if cfg.ssd else leaf["w"]
        assert bool(leaf.abs().sum() > 0)
    for (p, a), b in zip(tree.flatten_with_paths(got), tree.leaves(want)):
        a = a.cpu()
        assert bool(torch.isfinite(a).all()), p
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= 1e-3, (p, rel)
    mod, name = (ss, "ssd_scan") if cfg.ssd else (fa, "flash_attention")
    assert (mod.LAUNCHES[name], mod.RECOMPUTES[name]) == \
        (2 * cfg.num_layers, cfg.num_layers)


def test_cuda_agent_matches_a_cpu_agent(cuda):
    queries, scfg = drl_env.tpch_like_library()
    sim = drl_env.TraceSimulator(queries, scfg)
    acfg = drl_agent.A3CConfig(state_dim=sim.state_dim,
                               num_actions=scfg.num_candidates, seed=3)
    card = drl_agent.A3CAgent(acfg)               # the card by default
    cpu = drl_agent.A3CAgent(acfg, device="cpu")
    assert card.device.type == "cuda"
    for a, b in zip(card.params, cpu.params):      # seeded on the CPU
        assert torch.equal(a.cpu(), b)
    rows = []
    for _ in range(16):
        wl = sim.sample_workload()
        s, m = sim.state_of(wl)
        a = int(np.flatnonzero(m)[-1])
        rows.append(drl_agent.Transition(s, a, sim.reward_of(wl, a), m))
    st = torch.from_numpy(np.stack([r.state for r in rows]))
    with torch.no_grad():       # float32 GEMMs, summed in other orders
        for x, y in zip(card.net(st.to(cuda)), cpu.net(st)):
            assert float((x.cpu() - y).abs().max()) <= \
                1e-6 * float(y.abs().max())
    for r in rows:
        assert card.select(r.state, r.mask, greedy=True) == \
            cpu.select(r.state, r.mask, greedy=True)
    lg, _ = card.train_batch(rows)
    lc, _ = cpu.train_batch(rows)
    assert abs(lg - lc) <= 1e-5 * max(1.0, abs(lc))
    for a, b in zip(card.params, cpu.params):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


# -- the MoE and MLA layers -----------------------------------------------------

from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_padded_route_matches_twin(cuda, dtype):
    """deepseek-v2's head dims (nope 128 + rope 64, v 128): q and k padded
    to 256 through the kernel, against the plain twin on the unpadded
    tensors with the scale 1/sqrt(192)."""
    B, S, H, nd, rd, vd = 2, 320, 4, 128, 64, 128
    g = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    qn, qr, kn, v = rnd(B, S, H, nd), rnd(B, S, H, rd), rnd(B, S, H, nd), \
        rnd(B, S, H, vd)
    kr = rnd(B, S, rd)
    scale = 1.0 / (nd + rd) ** 0.5
    fa.reset_launches()
    got = tmla.padded_attention(qn, qr, kn, kr, v, scale)
    assert fa.LAUNCHES["flash_attention"] == 1
    q = torch.cat([qn, qr], -1).transpose(1, 2)
    k = torch.cat([kn, kr[:, :, None].expand(B, S, H, rd)], -1).transpose(1, 2)
    want = attention_ref(q, k, v.transpose(1, 2), causal=True,
                         scale=scale).transpose(1, 2)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, S, H, vd)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    err = torch.linalg.vector_norm(got.double() - want.double())
    assert float(err / torch.linalg.vector_norm(want.double())) <= 1e-2


def test_cuda_moe_ffn_matches_cpu(cuda):
    """deepseek's routing shape (top-6 of 16 experts, 2 shared) with drops:
    the same routing on the card as on the CPU, outputs within 1e-4."""
    E, k, D, F = 16, 6, 64, 32
    p = tmoe.moe_init(torch.Generator().manual_seed(0), D, F, E, 2,
                      torch.float32)
    x = torch.randn((3, 40, D), generator=torch.Generator().manual_seed(1))
    dp = _to_device(p, cuda)
    for factor in (1.25, 0.5):
        C = tmoe.capacity(120, E, k, factor)
        want_r = tmoe.route(p, x.reshape(-1, D), E, k, C)
        got_r = tmoe.route(dp, x.reshape(-1, D).to(cuda), E, k, C)
        for a, b in zip(got_r[:3], want_r[:3]):
            assert torch.equal(a.cpu(), b)
        want, waux = tmoe.moe_ffn(p, x, num_experts=E, top_k=k,
                                  capacity_factor=factor)
        got, gaux = tmoe.moe_ffn(dp, x.to(cuda), num_experts=E, top_k=k,
                                 capacity_factor=factor)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for key in waux:
            torch.testing.assert_close(gaux[key].cpu(), waux[key],
                                       atol=1e-5, rtol=1e-5)
    assert float(gaux["dropped_frac"]) > 0


# -- the SPMD layer: the kernels' custom ops, DTensor serving, flash decode ----

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import shardings as tshardings  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_custom_ops_match_twins(cuda, dtype):
    """Each kernel's custom op launches it (counted) and equals its plain
    twin; its fake implementation gives the real output's shape, dtype and
    strides."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = (torch.randn((2, 64, n, 64), generator=g, device=cuda)
               .to(dtype).transpose(1, 2) for n in (4, 2, 2))
    fa.reset_launches()
    got = fa_ops.flash_attention_op(q, k, v, True, 24, 0.0, None)
    assert fa.LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, causal=True, window=24)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    fake = fa_ops._flash_attention_fake(q, k, v, True, 24, 0.0, None)
    assert (fake.shape, fake.dtype, fake.stride()) == (got.shape, got.dtype,
                                                      got.stride())
    x = torch.randn((2, 128, 4, 32), generator=g, device=cuda).to(dtype)
    dt = torch.rand((2, 128, 4), generator=g, device=cuda) * 0.1
    A = -torch.rand((4,), generator=g, device=cuda)
    Bm, Cm = (torch.randn((2, 128, 32), generator=g, device=cuda).to(dtype)
              for _ in range(2))
    ss.reset_launches()
    y, st = ss_ops.ssd_scan_op(x, dt, A, Bm, Cm, 64)
    assert ss.LAUNCHES["ssd_scan"] == 1
    wy, wst = ssd_ref(x, dt, A, Bm, Cm, 64)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st.float(), wst.float(), atol=tol, rtol=tol)
    fy, fst = ss_ops._ssd_scan_fake(x, dt, A, Bm, Cm, 64)
    assert (fy.shape, fst.shape, fy.dtype) == (y.shape, st.shape, y.dtype)


def test_cuda_dtensor_serve_on_a_one_rank_mesh_equals_plain(cuda, tmp_path):
    """A reduced internlm2-1.8b (head_dim 32) whose parameters are DTensors
    on a real (1, 1) mesh of a one-rank NCCL world: ``serve_batch`` gives
    the plain run's ids, and its prefill launches flash once per layer
    through the kernel's sharding rule."""
    import dataclasses

    import torch.distributed as dist
    cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                              head_dim=32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dparams = _to_device(params, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40),
                                                dtype=np.int32)
    want, _ = tserve.serve_batch(cfg, dparams, prompts, 4, device=cuda)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        placed = tshardings.distribute(
            mesh, dparams, tshardings.param_pspecs(cfg, dparams, mesh))
        fa.reset_launches()
        got, _ = tserve.serve_batch(cfg, placed, prompts, 4, device=cuda)
        launched = fa.LAUNCHES["flash_attention"]
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got, want)
    assert launched == cfg.num_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_sdpa(cuda, dtype):
    """Flash decode over a cache of 8,192 + 40 slots, 8,000 of them valid,
    with a window and a softcap, against sdpa on the card."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, H, KV, hd, Skv, kv_len = 2, 8, 2, 64, 8232, 8000
    q = torch.randn((B, 1, H, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, Skv, KV, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    for window, cap in ((None, 0.0), (3000, 30.0)):
        kw = dict(kv_len=kv_len, window=window, attn_softcap=cap,
                  q_offset=kv_len - 1)
        got = tlayers.flash_decode(q, k, v, **kw)
        want = tlayers.sdpa(q, k, v, causal=True, **kw)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


# -- training the configs of chip phase 17 --------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "gemma2-27b"])
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """One training step of reduced deepseek-v2 (MLA through the padded
    flash route, MoE dispatch under autograd) and reduced gemma2-27b
    (attention and logit softcaps, window 8 under 48 tokens, local and
    global layers) on the card against the same weights on the CPU: the
    loss within 1e-4, every gradient leaf within 1e-3 of the CPU leaf's
    norm, the leaves reached only through the kernel nonzero, two flash
    launches and one recompute per attention layer under remat, and the
    donated step's parameters within 1e-3 of the CPU step's."""
    import dataclasses
    cfg = reduced(get_config(arch))
    if cfg.mla is None:
        cfg = dataclasses.replace(cfg, head_dim=32)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
             "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
    closs, _, want = TS.value_and_grad(cfg, params, batch)
    fa.reset_launches()
    dparams = _to_device(params, cuda)
    dbatch = {k: v.to(cuda) for k, v in batch.items()}
    loss, _, got = TS.value_and_grad(cfg, dparams, dbatch)
    assert abs(float(loss) - float(closs)) <= 1e-4 * abs(float(closs))
    keys = ("wq_b", "wkv_b") if cfg.mla else ("wq",)
    for layer in got["layers"]:
        for k in keys:
            assert bool(layer["attn"][k]["w"].abs().sum() > 0), k
    for (p, a), b in zip(tree.flatten_with_paths(got), tree.leaves(want)):
        a = a.cpu()
        assert bool(torch.isfinite(a).all()), p
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= 1e-3, (p, rel)
    assert (fa.LAUNCHES["flash_attention"],
            fa.RECOMPUTES["flash_attention"]) == \
        (2 * cfg.num_layers, cfg.num_layers)
    opt = TS.make_optimizer(cfg, peak_lr=3e-4, total_steps=4)
    cstate, _ = TS.make_train_step(cfg, opt)(
        {"params": params, "opt": opt.init(params)}, batch)
    dstate, met = TS.make_train_step(cfg, opt, donate=True)(
        {"params": dparams, "opt": opt.init(dparams)}, dbatch)
    assert bool(torch.isfinite(met["loss"]))
    for a, b in zip(tree.leaves(dstate["params"]),
                    tree.leaves(cstate["params"])):
        rel = float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= 1e-3, rel


# -- any head dim through the flash kernel ---------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b"])
def test_cuda_reduced_config_at_head_dim_16_serves_through_the_padded_kernel(
        cuda, arch):
    """A reduced config as it stands (head dim 16, float32) served on the
    card equals the same weights served on the CPU twin, id for id; its
    prefill launched the kernel once per layer (at head dim 32, zero-
    padded), while the launcher alone still refuses head dim 16."""
    cfg = reduced(get_config(arch))
    assert cfg.head_dim == 16
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40),
                                                dtype=np.int32)
    want, _ = tserve.serve_batch(cfg, params, prompts, 8, device="cpu")
    fa.reset_launches()
    got, _ = tserve.serve_batch(cfg, _to_device(params, cuda), prompts, 8,
                                device=cuda)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    np.testing.assert_array_equal(got, want)
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim 16"):
        fa.flash_attention(q, q, q)
