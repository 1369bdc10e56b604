"""The single-pass ``scatter_perm`` kernel's algorithm, emulated on the CPU.

The CUDA kernel (``csrc/hash_partition.cu``) cannot run here, so
:func:`emulate_single_pass_scatter` repeats its steps in numpy, as the
kernel takes them: tiles of ``SCATTER_TILE_ROWS`` rows; inside a tile,
warp sub-tiles of ``W`` rows ranked 32 rows a step with peer masks from one
ballot per key bit, ``popc(peers & lanemask_lt)`` and warp-private per-bin
counters, then a scan over the warps; and the decoupled look-back over one
flag a tile, polled one flag a thread, with the tiles taking their ids in
order and then publishing and polling in a seeded random interleaving,
each reading only what is already published.  Above
``SCATTER_SINGLE_PASS_MAX_BINS`` bins the three-pass kernels remain,
emulated by :func:`emulate_three_pass_scatter`.

Both must equal the plain version (``scatter_perm_ref``) and the JAX
package's Pallas kernel in interpret mode on the same numpy-seeded pids.
Mutations of the look-back (the wrong predecessor, no walk, a walk past an
unpublished flag) must fail, so the comparison is not blind to the part
that crosses tiles.  (The kernel itself against the plain version is in
``test_torch_cuda.py``.)
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_partition import hash_partition as jk  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as tk  # noqa: E402
from repro_torch.kernels.hash_partition import ops  # noqa: E402
from repro_torch.kernels.hash_partition import ref as tref  # noqa: E402

T = tk.SCATTER_TILE_ROWS
MAX_BINS = tk.SCATTER_SINGLE_PASS_MAX_BINS
# the kernels' geometry (test_emulated_geometry_is_the_kernels reads it
# from the source): a tile's threads, and the three-pass kernels' warp tile
THREADS = 512
W = T // (THREADS // 32)                # rows one warp ranks
THREE_PASS_TILE = 2048
FULL = (1 << 32) - 1
LANES = np.arange(32)
LANE_BIT = np.left_shift(np.int64(1), LANES)
LANEMASK_LT = LANE_BIT - 1


def _match_any(key, bins):
    """__match_any_sync: each lane's mask of the lanes holding its key
    (three passes)."""
    return ((key[..., :, None] == key[..., None, :]) * LANE_BIT).sum(-1)


def _match_ballots(key, bins):
    """The single pass's match: one ballot per bit of the key, which is
    the pid or ``bins`` for a pid outside [0, bins)."""
    peers = np.full(key.shape, FULL, np.int64)
    for b in range(int(bins).bit_length()):
        bit = (key >> b) & 1
        vote = (bit * LANE_BIT).sum(-1, keepdims=True)
        peers &= np.where(bit == 1, vote, ~vote & FULL)
    return peers


def _warp_rank(pid, valid, cnt, match=_match_any):
    """One step of a batch of warps, pid and valid (warps, 32): each lane's
    rank among equal pids, from the warps' running counters ``cnt``
    (warps, bins), updated in place."""
    bins = cnt.shape[-1]
    key = np.where(valid, pid, bins if match is _match_ballots else -1)
    peers = match(key, bins)
    leader = np.log2(peers & -peers).astype(np.int64)
    warps = np.arange(len(pid))[:, None]
    seen = np.where(valid, cnt[warps, np.where(valid, pid, 0)], 0)
    seen = np.take_along_axis(seen, leader, axis=1)
    rank = seen + np.bitwise_count(peers & LANEMASK_LT)
    lead = valid & (LANES == leader)
    w, lane = np.nonzero(lead)
    cnt[w, pid[w, lane]] = seen[lead] + np.bitwise_count(peers[lead])
    return rank


def _stage(tile_pids, bins):
    """A tile's pids, -1 past the end of the input, and which are in range."""
    staged = np.full(T, -1, np.int64)
    staged[:len(tile_pids)] = tile_pids
    return staged, (staged >= 0) & (staged < bins)


def _rank_tile(tile_pids, bins):
    """A tile's ranking: each warp ranks its W consecutive rows 32 a step
    (peer masks from ballots, a warp-private counter per bin); a scan over
    the warps in order gives their bases.  The warps step together here;
    each warp's steps depend only on its own counters.  Returns the staged
    pids, which are in range, each row's place among the tile's rows of its
    bin, and the tile's per-bin aggregate."""
    staged, valid = _stage(tile_pids, bins)
    cnt = np.zeros((T // W, bins), np.int64)
    rank = np.zeros((T // W, W), np.int64)
    by_warp, ok = staged.reshape(T // W, W), valid.reshape(T // W, W)
    for r0 in range(0, W, 32):
        sl = slice(r0, r0 + 32)
        rank[:, sl] = _warp_rank(by_warp[:, sl], ok[:, sl], cnt,
                                 _match_ballots)
    base = np.cumsum(cnt, axis=0) - cnt          # scan in warp order
    key = np.where(ok, by_warp, 0)
    local = base[np.arange(T // W)[:, None], key] + rank
    return staged, valid, local.reshape(T), cnt.sum(axis=0)


def _look_back(agg, counts, rng, mutation=None):
    """Steps 3-4 over every tile: each tile's exclusive prefix per bin (the
    bin bases included), under a seeded random interleaving.  Tiles take
    ids in order.  A tile with an id publishes its flag over its aggregate
    counts (tile 0: over its inclusive counts, seeded with the exclusive
    scan of ``counts``), then polls the flags of ``THREADS`` predecessors a
    round (one a thread), nearest first, until an inclusive one with every nearer one
    published (else it spins); its prefix is that tile's inclusive counts
    plus the nearer tiles' aggregates.  Also returns what the polls met."""
    n_tiles, bins = agg.shape
    flags = np.zeros(n_tiles, np.int64)
    aggregate = np.zeros((n_tiles, bins), np.int64)
    inclusive = np.zeros((n_tiles, bins), np.int64)
    prefix = np.zeros((n_tiles, bins), np.int64)
    stats = {"stalls": 0, "aggregates_summed": 0}
    taken, ranking, walking = 0, [], {}
    while taken < n_tiles or ranking or walking:
        choices = ([("take", None)] if taken < n_tiles else []) \
            + [("publish", t) for t in ranking] \
            + [("walk", t) for t in walking]
        what, t = choices[rng.integers(len(choices))]
        if what == "take":
            ranking.append(taken)
            taken += 1
        elif what == "publish":
            ranking.remove(t)
            if t == 0:
                prefix[0] = np.cumsum(counts) - counts
                inclusive[0] = prefix[0] + agg[0]
                flags[0] = 2
            else:
                aggregate[t] = agg[t]
                flags[t] = 1
                walking[t] = t - 1
        else:
            near = walking[t]
            j = near - np.arange(THREADS)
            if mutation == "wrong_predecessor":
                j = j - 1                       # flags one tile too far back
            f = np.where(j >= 0, flags[np.maximum(j, 0)], 2)
            if mutation == "past_unpublished":
                f = np.where(f == 0, 1, f)      # walks on as if published
            if mutation == "skip_walk" and f[0] != 0:
                f[0] = 2                        # takes the nearest as final
            first = int(np.argmax(f == 2)) if (f == 2).any() else THREADS
            if (f[:first + 1] == 0).any():
                stats["stalls"] += 1            # spin: poll again
                continue
            if first == THREADS:
                walking[t] = near - THREADS
                continue
            stop = near - first
            kind = inclusive if flags[stop] == 2 \
                or mutation == "wrong_predecessor" else aggregate
            prefix[t] = kind[stop] + aggregate[stop + 1:t].sum(axis=0)
            stats["aggregates_summed"] += int(flags[stop + 1:t].size
                                              + (flags[stop] != 2))
            inclusive[t] = prefix[t] + agg[t]
            flags[t] = 2
            del walking[t]
    return prefix, stats


def emulate_single_pass_scatter(pids, counts, *, seed=0, mutation=None,
                                with_stats=False):
    """dest (N,) int32 as the single-pass kernel computes it."""
    pids = np.asarray(pids, np.int64)
    counts = np.asarray(counts, np.int64)
    n, bins = len(pids), len(counts)
    dest = np.zeros(n, np.int32)
    stats = {"stalls": 0, "aggregates_summed": 0}
    if n:
        tiles = [_rank_tile(pids[s:s + T], bins) for s in range(0, n, T)]
        agg = np.stack([tile[3] for tile in tiles])
        prefix, stats = _look_back(agg, counts, np.random.default_rng(seed),
                                   mutation)
        for t, (staged, valid, local, _) in enumerate(tiles):
            rows = min(T, n - t * T)
            d = np.where(valid, prefix[t][np.where(valid, staged, 0)] + local,
                         0)
            dest[t * T:t * T + rows] = d[:rows]
    return (dest, stats) if with_stats else dest


def emulate_three_pass_scatter(pids, counts):
    """dest (N,) int32 as the three-pass kernels compute it: per-(bin, warp
    tile) counts, tile bases from the exclusive scans over bins and tiles,
    and each tile re-ranked 32 rows a step."""
    pids = np.asarray(pids, np.int64)
    counts = np.asarray(counts, np.int64)
    n, bins = len(pids), len(counts)
    dest = np.zeros(n, np.int32)
    tiles = range(0, n, THREE_PASS_TILE)
    valid = (pids >= 0) & (pids < bins)
    tile_counts = np.stack(
        [np.bincount(pids[s:s + THREE_PASS_TILE][valid[s:s + THREE_PASS_TILE]],
                     minlength=bins) for s in tiles]) if n else None
    for k, s in enumerate(tiles):
        off = (np.cumsum(counts) - counts
               + tile_counts[:k].sum(axis=0)).astype(np.int64)
        for r0 in range(s, min(s + THREE_PASS_TILE, n), 32):
            sl = slice(r0, min(r0 + 32, n))
            p = np.full(32, -1, np.int64)
            p[:sl.stop - r0] = pids[sl]
            v = (p >= 0) & (p < bins)
            d = np.where(v, _warp_rank(p[None], v[None], off[None])[0], 0)
            dest[sl] = d[:sl.stop - r0]
    return dest


def emulate_scatter(pids, counts, seed=0):
    """The kernel the CUDA launcher routes ``len(counts)`` bins to."""
    if tk.scatter_route(len(counts)) == "single_pass":
        return emulate_single_pass_scatter(pids, counts, seed=seed)
    return emulate_three_pass_scatter(pids, counts)


# -- references ------------------------------------------------------------------

def _pallas(pids, counts):
    return np.asarray(jk.scatter_perm(jnp.asarray(pids), jnp.asarray(counts),
                                      block=4096, interpret=True))


def _plain(pids, counts):
    """The plain version; sentinel rows are moved past the real rows first
    (a -1 would sort before them), so real rows keep their places."""
    bins = len(counts)
    real = (pids >= 0) & (pids < bins)
    key = np.where(real, pids, bins).astype(np.int32)
    dest = tref.scatter_perm_ref(torch.from_numpy(key),
                                 torch.from_numpy(counts)).numpy()
    return np.where(real, dest, 0).astype(np.int32)


def _counts(pids, bins):
    real = (pids >= 0) & (pids < bins)
    return np.bincount(pids[real], minlength=bins).astype(np.int32)


def _check(got, pids, counts):
    np.testing.assert_array_equal(got, _pallas(pids, counts))
    np.testing.assert_array_equal(got, _plain(pids, counts))


# -- the kernel's geometry -----------------------------------------------------------

def test_emulated_geometry_is_the_kernels():
    """The constants the emulation and the launcher use are the .cu's."""
    src = (Path(tk.__file__).parent / "csrc" / "hash_partition.cu"
           ).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kTileRows") == T
    assert const("kTileThreads") == THREADS
    assert const("kSinglePassMaxBins") == MAX_BINS
    assert const("kThreePassTileRows") == THREE_PASS_TILE
    # the look-back reads one flag a thread a round
    assert "near -= kTileThreads;" in src
    assert tk.scatter_route(MAX_BINS) == "single_pass"
    assert tk.scatter_route(MAX_BINS + 1) == "three_pass"


# -- the emulation against the plain version and the Pallas kernel ---------------

@pytest.mark.parametrize("bins", [1, 33, MAX_BINS, MAX_BINS + 1])
@pytest.mark.parametrize("n", [0, 1, 31, T - 1, T, T + 1, 5 * T + 7])
def test_emulation_matches_references(n, bins):
    pids = np.random.default_rng(n + bins).integers(0, bins, n).astype(
        np.int32)
    counts = _counts(pids, bins)
    got = emulate_scatter(pids, counts, seed=n)
    _check(got, pids, counts)
    np.testing.assert_array_equal(
        got, ops.scatter_permutation(torch.from_numpy(pids),
                                     torch.from_numpy(counts)).numpy())
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("bins", [33, MAX_BINS + 1])
def test_emulation_sentinels_move_no_real_row(bins):
    """-1 and pids at or past ``bins`` are never counted: their dest is 0
    (as the Pallas kernel writes) and real rows keep their places."""
    rng = np.random.default_rng(bins)
    n = 3 * T + 100
    pids = rng.integers(0, bins, n).astype(np.int32)
    pids[rng.integers(0, n, 500)] = -1
    pids[rng.integers(0, n, 500)] = bins + 3
    pids[rng.integers(0, n, 50)] = bins
    counts = _counts(pids, bins)
    got = emulate_scatter(pids, counts, seed=3)
    _check(got, pids, counts)
    assert not got[(pids < 0) | (pids >= bins)].any()


@pytest.mark.parametrize("m", [32, 256])
def test_emulation_padding_tail_in_overflow_bin(m):
    """The padded dispatch: rows at or past n_valid carry pid m, bin m of
    m + 1, and land after every valid row."""
    B, n_valid = 4 * T, 3 * T + 1234
    keys = torch.from_numpy(np.random.default_rng(m).integers(
        -2 ** 31, 2 ** 31 - 1, B).astype(np.int32))
    pids, counts = tref.hash_partition_padded_ref(keys, n_valid, m)
    pids, counts = pids.numpy(), counts.numpy()
    got = emulate_single_pass_scatter(pids, counts, seed=m)
    _check(got, pids, counts)
    assert np.array_equal(np.sort(got[n_valid:]), np.arange(n_valid, B))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["one_bin", "skewed"])
def test_emulation_any_completion_order(case, seed):
    """Several completion orders: every walk that crosses aggregates or
    stalls on an unpublished flag still gives the same bits."""
    rng = np.random.default_rng(seed)
    n, bins = 8 * T + 5, 33
    if case == "one_bin":
        pids = np.full(n, 7, np.int32)
    else:
        pids = rng.integers(0, bins, n).astype(np.int32)
        pids[rng.random(n) < 0.5] = 3
    counts = _counts(pids, bins)
    got, stats = emulate_single_pass_scatter(pids, counts, seed=seed,
                                             with_stats=True)
    _check(got, pids, counts)
    assert stats["aggregates_summed"] + stats["stalls"] > 0


def test_emulated_orders_exercise_the_look_back():
    """Across the seeds the walks both sum aggregates and stall."""
    pids = np.full(8 * T + 5, 7, np.int32)
    counts = _counts(pids, 33)
    total = {"stalls": 0, "aggregates_summed": 0}
    for seed in range(4):
        _, stats = emulate_single_pass_scatter(pids, counts, seed=seed,
                                               with_stats=True)
        for k in total:
            total[k] += stats[k]
    assert total["stalls"] > 0 and total["aggregates_summed"] > 0


@pytest.mark.parametrize("mutation", ["wrong_predecessor", "skip_walk",
                                      "past_unpublished"])
def test_look_back_mutations_fail_on_one_bin(mutation):
    """Negative control: a look-back that reads each predecessor's flag
    for the counts of the one after it, stops at the nearest flag it
    reads, or walks on past a flag not yet published breaks the
    all-one-bin case, where one bin's prefix chains through every tile:
    in at least two of the eight completion orders tried, and (the last
    two) in every order that meets what the mutation mishandles (a summed
    aggregate; an unpublished flag)."""
    pids = np.full(8 * T + 5, 7, np.int32)
    counts = _counts(pids, 33)
    want = _plain(pids, counts)
    meets = {"wrong_predecessor": lambda st: False,
             "skip_walk": lambda st: st["aggregates_summed"] > 0,
             "past_unpublished": lambda st: st["stalls"] > 0}[mutation]
    caught = 0
    for seed in range(8):
        got, stats = emulate_single_pass_scatter(pids, counts, seed=seed,
                                                 with_stats=True)
        np.testing.assert_array_equal(got, want)
        bad = emulate_single_pass_scatter(pids, counts, seed=seed,
                                          mutation=mutation)
        wrong = not np.array_equal(bad, want)
        assert wrong or not meets(stats), (mutation, seed)
        caught += wrong
    assert caught >= 2
