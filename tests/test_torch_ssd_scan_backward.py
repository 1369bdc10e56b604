"""The port's SSD backward on the CPU: its plain twin (``ssd_bwd_ref``)
against ``jax.vjp`` of the JAX package's ``models/ssd.py::ssd_scan_ref``,
the backward kernel's decomposition and bf16 roundings emulated in torch
on both routes of its row and column passes (the mma.sync ones and the
``wgmma`` passes, whose work partition is checked too), and its custom
op's fake implementation, dry-run cost, DTensor handling and launcher
checks.

Inputs are made with numpy from a seed and handed to both packages, in
two decay regimes as ``chip_smoke.py::ssd_inputs`` makes them: "fast"
(dt = softplus(randn), A = -exp(0.3 randn)) and "slow" (Mamba-2's
published init: dt log-uniform in [1e-3, 1e-1], A = -U(1, 16)).
Tolerances: float32 within 1e-4 of each gradient's max |grad| (the same
function, its sums in another order); the bf16 kernel's emulation, which
rounds gy·exp(cs), the carried states and the decay-weighted tiles to
bfloat16 before their products (x·w in two bf16 parts), within 5e-2 of
max |grad| and
relative RMS ``||got - want|| / ||want||`` at most 1e-2, the forward's
bf16 limits.

The CUDA kernels cannot run here; ``tests/test_torch_cuda.py`` holds them
to the twin on the card, and ``chip_smoke.py`` phase 6 at the models'
shapes.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.ssd import ssd_scan_ref as jssd_scan_ref  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref, ssd_ref  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402

F32_TOL = 1e-4
BF16_TOL, RMS_LIMIT = 5e-2, 1e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (B, T, H, P, N, chunk): one chunk and several; chunk 16, 32, 64 and 256;
# P 16, 32 and 64; N 32 and 128 (the last mamba2's widths)
CASES = [
    (1, 16, 2, 16, 32, 16),
    (2, 64, 3, 16, 32, 16),
    (1, 96, 2, 32, 32, 32),
    (2, 128, 2, 64, 128, 64),
    (1, 256, 2, 32, 128, 256),
    (1, 512, 2, 64, 128, 256),
]


def _arrays(B, T, H, P, N, seed, decay, gstate):
    """x, dt, A, B, C as chip_smoke.ssd_inputs makes them, gy and gstate
    (zeros, or a draw)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(f32)
    if decay == "fast":
        dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(f32)
        A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                (B, T, H))).astype(f32)
        A = (-rng.uniform(1.0, 16.0, H)).astype(f32)
    Bm = (rng.standard_normal((B, T, N)) * 0.3).astype(f32)
    Cm = (rng.standard_normal((B, T, N)) * 0.3).astype(f32)
    gy = rng.standard_normal((B, T, H, P)).astype(f32)
    gs = rng.standard_normal((B, H, P, N)).astype(f32)
    return x, dt, A, Bm, Cm, gy, gs * (gstate == "nonzero")


def _jax_vjp(arrays, chunk):
    """(dx, ddt, dA, dB, dC) of the reference's ssd_scan_ref, float32."""
    x, dt, A, Bm, Cm, gy, gs = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda *a: jssd_scan_ref(*a, chunk), x, dt, A, Bm, Cm)
    return [np.asarray(g) for g in vjp((gy, gs))]


def _share(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16_values(arrays):
    """x, B, C, gy and gstate rounded to bfloat16 (as float32); dt and A
    float32, as the model hands them over."""
    return [a if i in (1, 2) else np.asarray(
        torch.from_numpy(a).bfloat16().float()) for i, a in enumerate(arrays)]


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", CASES)
def test_backward_twin_equals_jax_vjp(case, decay, gstate):
    """ssd_bwd_ref equals jax.vjp of the reference's ssd_scan_ref for all
    five gradients (float32)."""
    arrays = _arrays(*case[:5], seed=sum(case), decay=decay, gstate=gstate)
    want = _jax_vjp(arrays, case[5])
    got = ssd_bwd_ref(*(torch.from_numpy(a) for a in arrays), case[5])
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _share(g.numpy(), w) <= F32_TOL, (name, _share(g.numpy(), w))


# -- the backward kernel's decomposition and roundings, in torch ----------------


def emulate_backward(x, dt, A, Bm, Cm, gy, gstate, chunk, rnd=None,
                     drop=None, route=None, groups=None):
    """The backward kernels' arithmetic in torch (csrc/ssd_scan_bwd.cu),
    launch by launch on tiles of ``tk.kernel_tile(chunk)`` rows, from
    float32 tensors holding the inputs' values; ``rnd`` rounds each
    product operand the bf16 kernel rounds (None: float32, no rounding),
    and x·w of the states' pass is taken as two rounded parts, as the
    kernel takes it.  ``route`` names the row and column passes
    (``tk.backward_route``; by default the one the kernel takes for these
    shapes in bfloat16 when ``rnd`` is given, else in float32): "tiles",
    the mma.sync passes, or "wgmma", their redesign, whose work items, pairing,
    head groups (``groups``, by default ``tk.head_groups``'s) and sums in
    warpgroup order :func:`_wgmma_passes` follows.
    ``drop`` = (output tile i, key tile j) leaves that tile pair's
    intra-chunk terms out of every chunk (the negative control).  Returns
    (dx, ddt, dA, dB, dC); dx, dB and dC rounded by ``rnd`` as written."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if route is None:
        route = tk.backward_route(torch.bfloat16 if rnd else torch.float32,
                                  P, N, chunk)
    rnd = rnd or (lambda t: t)

    def split(t):               # hi + lo, two bf16 operands of one sum
        return rnd(t) + rnd(t - rnd(t))
    L, TL = chunk, tk.kernel_tile(chunk)
    nc, nt = T // L, L // TL
    xh = x.permute(0, 2, 1, 3)                               # (B,H,T,P)
    gyh = gy.permute(0, 2, 1, 3)
    dth = dt.permute(0, 2, 1)                                 # (B,H,T)
    bm, cm = Bm[:, None], Cm[:, None]                         # (B,1,T,N)
    # 1. the cumsum (in order), each chunk's own state and cotangent
    cum = torch.cumsum((dth * A[:, None]).reshape(Bsz, H, nc, L), -1)
    cum = cum.reshape(Bsz, H, T)
    own, down = [], []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        cs = cum[..., sl]
        w = torch.exp(cs[..., -1:] - cs) * dth[..., sl]
        own.append(split(xh[:, :, sl] * w[..., None]).transpose(-1, -2)
                   @ bm[:, :, sl])
        down.append(rnd(gyh[:, :, sl] * torch.exp(cs)[..., None])
                    .transpose(-1, -2) @ cm[:, :, sl])
    # 2. states carried forward, cotangents back, <h_c, dh>
    decay = torch.exp(cum[..., L - 1::L])                     # (B,H,nc)
    h = torch.zeros((Bsz, H, P, N))
    st, dst, hd = [None] * nc, [None] * nc, [None] * nc
    for c in range(nc):
        st[c] = h
        h = h * decay[..., c, None, None] + own[c]
    dh = gstate
    for c in reversed(range(nc)):
        dst[c] = dh
        hd[c] = (st[c] * dh).sum((-1, -2))
        dh = dh * decay[..., c, None, None] + down[c]
    if route == "wgmma":
        # 3-4. the redesigned passes
        rq, ce, us, dx, dB, dC = _wgmma_passes(
            xh, gyh, dth, bm, cm, cum, [rnd(t) for t in st],
            [rnd(t) for t in dst], chunk, rnd, drop, groups)
    else:
        rq, ce, us, dx, dB, dC = _tile_passes(
            xh, gyh, dth, bm, cm, cum, [rnd(t) for t in st],
            [rnd(t) for t in dst], chunk, rnd, drop)
    # 5. dcs, its reverse cumsum, ddt and dA
    direct = ce + us
    dcs = (rq - dth * direct).reshape(Bsz, H, nc, L)
    dcs[..., -1] += (dth * us).reshape(Bsz, H, nc, L).sum(-1) \
        + decay * torch.stack(hd, -1)
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    da = da.reshape(Bsz, H, T)
    ddt = A[None, :, None] * da + direct
    dA = (dth * da).sum((0, 2))
    return (rnd(dx.permute(0, 2, 1, 3)), ddt.permute(0, 2, 1), dA, rnd(dB),
            rnd(dC))


def _decay_tile(cs, i, j, TL):
    """D[l, s] of a chunk's cumsum ``cs`` for rows l of tile i and s of
    tile j (0 where s > l)."""
    d = torch.exp(cs[..., i * TL:(i + 1) * TL, None]
                  - cs[..., None, j * TL:(j + 1) * TL])
    if i == j:
        rows = torch.arange(TL)
        d = torch.where(rows[None, :] <= rows[:, None], d, 0.0)
    return d


def _tile_passes(xh, gyh, dth, bm, cm, cum, h_ops, dh_ops, chunk, rnd,
                 drop):
    """The mma.sync row and column passes (bwd_rows, bwd_cols): a CTA a tile,
    the heads of the group in order into one sum.  Returns (rq, ce, us,
    dx (B,H,T,P), dB, dC)."""
    Bsz, H, T, P = xh.shape
    N = bm.shape[-1]
    L, TL = chunk, tk.kernel_tile(chunk)
    nc, nt = T // L, L // TL
    rq = torch.zeros((Bsz, H, T))
    ce = torch.zeros((Bsz, H, T))
    us = torch.zeros((Bsz, H, T))
    dx = torch.zeros((Bsz, H, T, P))
    dB = torch.zeros((Bsz, T, N))
    dC = torch.zeros((Bsz, T, N))
    for c in range(nc):
        t0 = c * L
        cs, dtc = cum[..., t0:t0 + L], dth[..., t0:t0 + L]
        h_op, dh_op = h_ops[c], dh_ops[c]

        def tile(t, k):
            return t[..., t0 + k * TL:t0 + (k + 1) * TL, :]
        # 3. rows: dC and the rows' dcs terms
        for i in range(nt):
            ci, gi = tile(cm, i), tile(gyh, i)
            e = torch.exp(cs[..., i * TL:(i + 1) * TL])
            t1 = gi @ h_op
            acc = e[..., None] * t1
            rs = e * (t1 * ci).sum(-1)
            for j in range(i + 1):
                if (i, j) == drop:
                    continue
                G = ci @ tile(bm, j).transpose(-1, -2)
                md = (gi @ tile(xh, j).transpose(-1, -2)) \
                    * _decay_tile(cs, i, j, TL) \
                    * dtc[..., None, j * TL:(j + 1) * TL]
                rs = rs + (G * md).sum(-1)
                acc = acc + rnd(md) @ tile(bm, j)
            dC[:, t0 + i * TL:t0 + (i + 1) * TL] += acc.sum(1)
            rq[..., t0 + i * TL:t0 + (i + 1) * TL] = rs
        # 4. columns: dx, dB, ce and u
        for j in range(nt):
            bj, xj = tile(bm, j), tile(xh, j)
            sl = slice(j * TL, (j + 1) * TL)
            ew = torch.exp(cs[..., -1:] - cs[..., sl])
            w = ew * dtc[..., sl]
            dxa = w[..., None] * (bj @ dh_op.transpose(-1, -2))
            t3 = xj @ dh_op
            us[..., t0 + j * TL:t0 + (j + 1) * TL] = ew * (t3 * bj).sum(-1)
            db = w[..., None] * t3
            ca = torch.zeros_like(w)
            for i in range(j, nt):
                if (i, j) == drop:
                    continue
                ci, gi = tile(cm, i), tile(gyh, i)
                d = _decay_tile(cs, i, j, TL).transpose(-1, -2)   # [s, l]
                gd = (ci @ bj.transpose(-1, -2)).transpose(-1, -2) * d
                mt = xj @ gi.transpose(-1, -2)
                ca = ca + (gd * mt).sum(-1)
                db = db + rnd(mt * d * dtc[..., sl, None]) @ ci
                dxa = dxa + rnd(gd * dtc[..., sl, None]) @ gi
            ce[..., t0 + j * TL:t0 + (j + 1) * TL] = ca
            dx[..., t0 + j * TL:t0 + (j + 1) * TL, :] = dxa
            dB[:, t0 + j * TL:t0 + (j + 1) * TL] += db.sum(1)
    return rq, ce, us, dx, dB, dC


def _wgmma_fold(chunk, f, cols):
    """The tiles fold ``f`` takes (``bwd_wgrows``/``bwd_wgcols``'s
    ``fold_tile``), in the order its CTA takes them (the one with more
    tile pairs first): rows ``nt - 1 - f`` then ``f``, columns ``f`` then
    ``nt - 1 - f``."""
    nt = chunk // tk.WG_TILE
    big = nt - 1 - f
    tiles = (f, big) if cols else (big, f)
    return tiles[:1] if big == f else tiles


def _wgmma_pairs(chunk, tile, cols):
    """A tile's pairs as the two warpgroups of its CTA share them: pair k
    (rows: key tile j = k <= tile; columns: row tile i = tile + k) to
    warpgroup k % 2, and the warpgroup that also takes dx's state term
    (columns: 0 when the tile has an even number of pairs, else 1; rows:
    none).  Warpgroup 1 takes the other state terms (dC's, dB's)."""
    nt = chunk // tk.WG_TILE
    pairs = tuple(range(tile, nt)) if cols else tuple(range(tile + 1))
    return pairs[0::2], pairs[1::2], (len(pairs) & 1 if cols else -1)


def _wgmma_passes(xh, gyh, dth, bm, cm, cum, h_ops, dh_ops, chunk, rnd,
                  drop, groups=None):
    """The redesigned passes (bwd_wgrows, bwd_wgcols), CTA by CTA: each
    (fold, chunk, batch row, head group) takes the fold's tiles in order
    (:func:`_wgmma_fold`); each tile's pairs go to two warpgroups
    (:func:`_wgmma_pairs`), each with G for its pairs once and its own sums
    over the group's heads in order, M once a (head, pair); dC and dB add
    warpgroup 1's sum to warpgroup 0's at the tile's end, dx at each
    head's, rq and ce in bwd_dt (the two parts summed there); the groups'
    dB and dC summed in group order.  Batch rows run side by side, as the
    kernel's CTAs of one (fold, chunk, group) do.  Returns (rq, ce, us, dx
    (B,H,T,P), dB, dC)."""
    Bsz, H, T, P = xh.shape
    N = bm.shape[-1]
    L, TL = chunk, tk.WG_TILE
    nc = T // L
    groups = groups or tk.head_groups(Bsz, T, H, chunk, "wgmma")
    hpg = -(-H // groups)
    groups = -(-H // hpg)
    rq = [torch.zeros((Bsz, H, T)) for _ in range(2)]
    ce = [torch.zeros((Bsz, H, T)) for _ in range(2)]
    us = torch.zeros((Bsz, H, T))
    dx = torch.zeros((Bsz, H, T, P))
    dBp = torch.zeros((groups, Bsz, T, N))
    dCp = torch.zeros((groups, Bsz, T, N))
    for c in range(nc):
        t0 = c * L
        cs, dtc = cum[..., t0:t0 + L], dth[..., t0:t0 + L]

        def tile(t, k):
            return t[..., t0 + k * TL:t0 + (k + 1) * TL, :]

        def rows(k):
            return slice(t0 + k * TL, t0 + (k + 1) * TL)
        for grp in range(groups):
            heads = range(grp * hpg, min(H, (grp + 1) * hpg))
            for f in range(tk.wgmma_folds(chunk)):
                for i in _wgmma_fold(chunk, f, cols=False):    # rows
                    pairs = _wgmma_pairs(chunk, i, cols=False)[:2]
                    ci = tile(cm, i)[:, 0]
                    G = {j: ci @ tile(bm, j)[:, 0].transpose(-1, -2)
                         for js in pairs for j in js}
                    e = torch.exp(cs[..., i * TL:(i + 1) * TL])
                    acc = [torch.zeros((Bsz, TL, N)) for _ in range(2)]
                    for hh in heads:
                        gi = tile(gyh, i)[:, hh]
                        t1 = gi @ h_ops[c][:, hh]
                        acc[1] = acc[1] + e[:, hh, :, None] * t1
                        rs = [torch.zeros((Bsz, TL)), e[:, hh] * (
                            t1 * ci).sum(-1)]
                        for wgi, js in enumerate(pairs):
                            part = torch.zeros((Bsz, TL))
                            for j in js:
                                if (i, j) == drop:
                                    continue
                                md = (gi @ tile(xh, j)[:, hh].transpose(-1, -2)
                                      ) * _decay_tile(cs, i, j, TL)[:, hh] \
                                    * dtc[:, hh, None, j * TL:(j + 1) * TL]
                                part = part + (G[j] * md).sum(-1)
                                acc[wgi] = acc[wgi] + rnd(md) \
                                    @ tile(bm, j)[:, 0]
                            rq[wgi][:, hh, rows(i)] = part + (rs[1] if wgi
                                                              else 0.0)
                    dCp[grp, :, rows(i)] = acc[0] + acc[1]
                for j in _wgmma_fold(chunk, f, cols=True):     # columns
                    *pairs, dx_wg = _wgmma_pairs(chunk, j, cols=True)
                    bj = tile(bm, j)[:, 0]
                    GT = {i: bj @ tile(cm, i)[:, 0].transpose(-1, -2)
                          for is_ in pairs for i in is_}
                    sl = slice(j * TL, (j + 1) * TL)
                    acc = [torch.zeros((Bsz, TL, N)) for _ in range(2)]
                    for hh in heads:
                        xj = tile(xh, j)[:, hh]
                        ew = torch.exp(cs[:, hh, -1:] - cs[:, hh, sl])
                        dts = dtc[:, hh, sl]
                        w = ew * dts
                        dxs = [torch.zeros((Bsz, TL, P)) for _ in range(2)]
                        dxs[dx_wg] = w[..., None] * (
                            bj @ dh_ops[c][:, hh].transpose(-1, -2))
                        t3 = xj @ dh_ops[c][:, hh]
                        us[:, hh, rows(j)] = ew * (t3 * bj).sum(-1)
                        acc[1] = acc[1] + w[..., None] * t3
                        for wgi, is_ in enumerate(pairs):
                            ca = torch.zeros((Bsz, TL))
                            for i in is_:
                                if (i, j) == drop:
                                    continue
                                gi = tile(gyh, i)[:, hh]
                                d = _decay_tile(cs, i, j, TL)[:, hh] \
                                    .transpose(-1, -2)                # [s, l]
                                gd = GT[i] * d
                                mt = xj @ gi.transpose(-1, -2)
                                ca = ca + (gd * mt).sum(-1)
                                acc[wgi] = acc[wgi] + rnd(
                                    mt * d * dts[..., None]) \
                                    @ tile(cm, i)[:, 0]
                                dxs[wgi] = dxs[wgi] + rnd(
                                    gd * dts[..., None]) @ gi
                            ce[wgi][:, hh, rows(j)] = ca
                        dx[:, hh, rows(j)] = dxs[0] + dxs[1]
                    dBp[grp, :, rows(j)] = acc[0] + acc[1]
    dB, dC = dBp[0], dCp[0]
    for grp in range(1, groups):
        dB, dC = dB + dBp[grp], dC + dCp[grp]
    return rq[0] + rq[1], ce[0] + ce[1], us, dx, dB, dC


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_decomposition_equals_jax_vjp(case, decay, gstate):
    """The kernels' decomposition (the six launches' tables and tile
    pairs) without rounding equals jax.vjp of the reference within the
    float32 limit."""
    arrays = _arrays(*case[:5], seed=sum(case) + 1, decay=decay,
                     gstate=gstate)
    want = _jax_vjp(arrays, case[5])
    got = emulate_backward(*(torch.from_numpy(a) for a in arrays), case[5])
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _share(g.numpy(), w) <= F32_TOL, (name, _share(g.numpy(), w))


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", CASES)
def test_bf16_kernel_emulation_matches_jax_vjp(case, decay, gstate):
    """The bf16 kernel's roundings keep each gradient within 5e-2 of max
    |grad| and 1e-2 relative RMS of jax.vjp of the reference at the same
    bfloat16 values."""
    arrays = _bf16_values(_arrays(*case[:5], seed=sum(case) + 2,
                                  decay=decay, gstate=gstate))
    want = _jax_vjp(arrays, case[5])
    got = emulate_backward(*(torch.from_numpy(a) for a in arrays), case[5],
                           rnd=_bf16)
    for name, g, w in zip(NAMES, got, want):
        got_ = g.numpy()
        assert _share(got_, w) <= BF16_TOL, (name, _share(got_, w))
        assert _rel_rms(got_, w) <= RMS_LIMIT, (name, _rel_rms(got_, w))


# (B, T, H, P, N, chunk, head groups) the redesigned passes take (P 64, N
# 64 or 128, chunks a multiple of 64): chunk 64, 128, 192 (an odd number of
# tiles) and 256; several chunks; 3 heads in 2 groups (2, 1) and 5 in 3
# (2, 2, 1), as head_groups splits (5, 1024, 5) at chunk 256; None: the
# launcher's groups
WG_CASES = [
    (2, 128, 2, 64, 128, 64, None),
    (1, 512, 3, 64, 128, 128, 2),
    (2, 384, 2, 64, 64, 192, None),
    (1, 512, 5, 64, 128, 256, 3),
]


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", WG_CASES)
def test_wgmma_decomposition_equals_jax_vjp(case, decay, gstate):
    """The redesigned passes' decomposition (folds, the two warpgroups'
    pairs and state terms, head groups, sums in warpgroup order) without
    rounding equals jax.vjp of the reference within the float32 limit."""
    assert tk.backward_route(torch.bfloat16, *case[3:6]) == "wgmma"
    arrays = _arrays(*case[:5], seed=sum(case[:6]) + 3, decay=decay,
                     gstate=gstate)
    want = _jax_vjp(arrays, case[5])
    got = emulate_backward(*(torch.from_numpy(a) for a in arrays), case[5],
                           route="wgmma", groups=case[6])
    for name, g, w in zip(NAMES, got, want):
        assert _share(g.numpy(), w) <= F32_TOL, (name, _share(g.numpy(), w))


@pytest.mark.parametrize("gstate", ["zero", "nonzero"])
@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", WG_CASES)
def test_wgmma_bf16_emulation_matches_jax_vjp(case, decay, gstate):
    """The redesigned passes with the bf16 kernel's roundings keep each
    gradient within 5e-2 of max |grad| and 1e-2 relative RMS of jax.vjp of
    the reference at the same bfloat16 values."""
    arrays = _bf16_values(_arrays(*case[:5], seed=sum(case[:6]) + 4,
                                  decay=decay, gstate=gstate))
    want = _jax_vjp(arrays, case[5])
    got = emulate_backward(*(torch.from_numpy(a) for a in arrays), case[5],
                           rnd=_bf16, route="wgmma", groups=case[6])
    for name, g, w in zip(NAMES, got, want):
        got_ = g.numpy()
        assert _share(got_, w) <= BF16_TOL, (name, _share(got_, w))
        assert _rel_rms(got_, w) <= RMS_LIMIT, (name, _rel_rms(got_, w))


def _wgmma_schedule(Bsz, T, H, chunk):
    """The redesigned passes' CTAs as the kernel walks them: for each
    (fold, chunk, batch row, group) CTA and pass, its (tile, head,
    warpgroup, pair) visits in order, and its state terms."""
    groups = tk.head_groups(Bsz, T, H, chunk, "wgmma")
    hpg = -(-H // groups)
    groups = -(-H // hpg)
    ctas = []
    for f in range(tk.wgmma_folds(chunk)):
        for c in range(T // chunk):
            for b in range(Bsz):
                for grp in range(groups):
                    heads = range(grp * hpg, min(H, (grp + 1) * hpg))
                    cta = {"rows": [], "cols": [], "states": []}
                    for cols in (False, True):
                        for tile in _wgmma_fold(chunk, f, cols):
                            *pairs, dx_wg = _wgmma_pairs(chunk, tile, cols)
                            for h in heads:
                                for wgi, ks in enumerate(pairs):
                                    for k in ks:
                                        ij = (k, tile) if cols else (tile, k)
                                        cta["cols" if cols else "rows"] \
                                            .append((b, c, ij, h, wgi))
                                cta["states"].append(
                                    (cols, tile, h, dx_wg if cols else 1))
                    ctas.append(cta)
    return ctas


@pytest.mark.parametrize("dims", [
    (8, 2048, 32, 256),             # mamba2-370m's training step
    (8, 4096, 32, 256),             # phase 6's table shape
    (5, 1024, 5, 256),              # 5 heads in 3 groups (2, 2, 1)
    (3, 512, 7, 64),                # one tile a chunk
    (2, 512, 3, 128),               # two tiles a chunk
    (4, 384, 5, 192),               # three: the middle tile alone
])
def test_wgmma_partition_covers_each_pair_once(dims):
    """The redesigned passes' work partition: every (batch row, chunk,
    tile pair, head) is visited exactly once by each pass, every CTA does
    nt + 1 tile pairs a head (the middle tile of an odd nt: (nt + 1) / 2),
    the two warpgroups' shares differ by at most one pair's work, and the
    order of every sum (the visits of each output tile, CTA by CTA) is a
    function of the shapes alone."""
    Bsz, T, H, chunk = dims
    nt = chunk // tk.WG_TILE
    ctas = _wgmma_schedule(*dims)
    assert ctas == _wgmma_schedule(*dims)
    want = sorted((b, c, (i, j), h) for b in range(Bsz)
                  for c in range(T // chunk) for i in range(nt)
                  for j in range(i + 1) for h in range(H))
    for name in ("rows", "cols"):
        got = sorted(v[:4] for cta in ctas for v in cta[name])
        assert got == want, name
    for cta in ctas:
        nh = len({v[3] for v in cta["rows"]})
        pairs = len(cta["rows"]) // nh
        assert pairs == len(cta["cols"]) // nh
        tiles = {v[2][0] for v in cta["rows"]}
        assert pairs == (nt + 1 if len(tiles) == 2 else (nt + 1) // 2)
        # rows: a pair is M and dC (1.5 units), dC's state term 1; columns:
        # a pair is M, dB and dx (2), each state term 1
        for name, unit in (("rows", 1.5), ("cols", 2.0)):
            work = [unit * sum(v[4] == w for v in cta[name]) / nh
                    for w in (0, 1)]
            for cols, tile, h, wgs in cta["states"]:
                if cols == (name == "cols") and h == cta[name][0][3]:
                    work[1] += 1.0
                    work[wgs] += 1.0 if cols else 0.0
            assert abs(work[0] - work[1]) <= unit, (name, work)


def test_rel_rms_check_catches_a_dropped_tile_pair():
    """Negative control under slow decay at mamba2's widths: the emulated
    bf16 kernel passes the relative-RMS check on every gradient, and with
    tile pair (3, 2) (rows 192-255 against keys 128-191 of every chunk)
    left out of the intra-chunk terms dx, dB and dC fail it."""
    arrays = _bf16_values(_arrays(1, 512, 4, 64, 128, seed=5, decay="slow",
                                  gstate="nonzero"))
    want = _jax_vjp(arrays, 256)
    ins = [torch.from_numpy(a) for a in arrays]
    whole = emulate_backward(*ins, 256, rnd=_bf16)
    dropped = emulate_backward(*ins, 256, rnd=_bf16, drop=(3, 2))
    for name, g, w in zip(NAMES, whole, want):
        assert _rel_rms(g.numpy(), w) <= RMS_LIMIT, name
    for name in ("dx", "dB", "dC"):
        k = NAMES.index(name)
        assert _rel_rms(dropped[k].numpy(), want[k]) > RMS_LIMIT, name


def test_twin_gives_the_launchers_types():
    """ssd_bwd_ref returns what the launcher returns: dx, dB and dC in
    x's dtype, ddt and dA float32, from bfloat16 inputs."""
    arrays = _arrays(1, 32, 2, 16, 16, seed=9, decay="fast",
                     gstate="nonzero")
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4, 5, 6):
        t[i] = t[i].bfloat16()
    dx, ddt, dA, dB, dC = ssd_bwd_ref(*t, 16)
    assert dx.dtype == dB.dtype == dC.dtype == torch.bfloat16
    assert ddt.dtype == dA.dtype == torch.float32
    assert (dx.shape, ddt.shape, dA.shape, dB.shape) == (
        (1, 32, 2, 16), (1, 32, 2), (2,), (1, 32, 16))


# -- the op on meta tensors, DTensors, and the launcher's checks ----------------


def _meta_inputs(B, T, H, P, N, dtype=torch.bfloat16, grad=False):
    x = torch.empty((B, T, H, P), device="meta", dtype=dtype)
    dt = torch.empty((B, T, H), device="meta")
    A = torch.empty((H,), device="meta")
    Bm = torch.empty((B, T, N), device="meta", dtype=dtype)
    ins = [x, dt, A, Bm, torch.empty_like(Bm)]
    return [t.requires_grad_() for t in ins] if grad else ins


def test_fake_op_gives_the_kernels_shapes():
    """The backward op's fake implementation: dx (B,T,H,P), dB and dC
    (B,T,N) in x's dtype, ddt (B,T,H) and dA (H,) float32."""
    x, dt, A, Bm, Cm = _meta_inputs(2, 64, 4, 32, 48)
    gy = torch.empty_like(x)
    gs = torch.empty((2, 4, 32, 48), device="meta", dtype=torch.bfloat16)
    dx, ddt, dA, dB, dC = ops.ssd_scan_backward_op(x, dt, A, Bm, Cm, gy, gs,
                                                   16)
    assert (dx.shape, dx.dtype) == (x.shape, torch.bfloat16)
    assert (ddt.shape, ddt.dtype) == (dt.shape, torch.float32)
    assert (dA.shape, dA.dtype) == ((4,), torch.float32)
    for g in (dB, dC):
        assert (g.shape, g.dtype) == ((2, 64, 48), torch.bfloat16)


def test_dry_run_charges_the_backward_its_cost():
    """One gradient through the dispatcher on meta tensors: the forward op
    and the backward op each run once, charged ssd_scan_cost and
    ssd_scan_bwd_cost (C B^T once per chunk, the other products per head,
    over the causal triangles)."""
    ins = _meta_inputs(2, 64, 4, 16, 32, grad=True)

    def grad():
        y, st = ops.ssd(*ins, chunk=16)
        return torch.autograd.grad((y, st), ins, (torch.empty_like(y),
                                                  torch.empty_like(st)))
    grads, t = op_analysis.count(grad)
    assert [g.shape for g in grads] == [i.shape for i in ins]
    assert t.kernel_calls == {"ssd_scan": 1, "ssd_scan_backward": 1}
    fwd = cost.ssd_scan_cost(2, 64, 4, 16, 32, 16, 2)
    bwd = cost.ssd_scan_bwd_cost(2, 64, 4, 16, 32, 16, 2)
    assert t.flops == fwd[0] + bwd[0]
    tri = 16 * 17 / 2
    assert bwd[0] == 2 * 2 * 4 * (tri * 32 + 4 * (2 * tri * 16 + 2 * tri * 32
                                                   + 5 * 16 * 16 * 32))
    assert bwd[1] == 2 * (3 * 2 * 64 * 4 * 16 + 4 * 2 * 64 * 32
                          + 2 * 4 * 16 * 32) + 4 * 2 * (2 * 64 * 4 + 4)
    # the products of a training shape: about three times the forward's
    big = (8, 2048, 32, 64, 128, 256, 2)
    assert 3 < cost.ssd_scan_bwd_cost(*big)[0] / cost.ssd_scan_cost(*big)[0] \
        < 4


def test_dry_run_rejects_a_kernel_op_without_a_formula():
    """The dry run charges each kernel op by its own formula; an op it has
    none for raises instead of taking another kernel's cost."""
    with pytest.raises(KeyError, match="no_such_kernel"):
        op_analysis._kernel_cost("no_such_kernel", ())


@pytest.mark.parametrize("layout", ["batch", "heads"])
def test_backward_keeps_a_dtensors_layout(layout):
    """Meta DTensors on a fake one-rank (1,) mesh and on a fake (2, 2)
    mesh, in the forward rule's batch- or head-sharded layout: the forward
    and the backward op run on each rank's shards (one call each), every
    gradient is a DTensor of its input's shape, and on the (2, 2) mesh the
    gradient of the input the layout replicates (A when batch-sharded, B
    and C when head-sharded) is partial over the axes that split the work,
    the others sharded as their inputs."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.launch.mesh import fake_world, make_mesh
    R = Replicate()
    lay = ({"x": Shard(0), "dt": Shard(0), "A": R, "B": Shard(0),
            "C": Shard(0)} if layout == "batch" else
           {"x": Shard(2), "dt": Shard(2), "A": Shard(0), "B": R, "C": R})
    partial = {"A"} if layout == "batch" else {"B", "C"}
    for world, shape, names in ((1, (1,), ("data",)),
                                (4, (2, 2), ("data", "model"))):
        with fake_world(world):
            mesh = make_mesh(shape, names)
            ins = [distribute_tensor(t, mesh, [p] * len(shape))
                   .requires_grad_()
                   for t, p in zip(_meta_inputs(4, 64, 4, 16, 32),
                                   lay.values())]

            def grad():
                y, st = ops.ssd(*ins, chunk=16)
                return torch.autograd.grad(y, ins, torch.ones_like(y))
            grads, t = op_analysis.count(grad, mesh=mesh)
            assert t.kernel_calls == {"ssd_scan": 1, "ssd_scan_backward": 1}
            for name, g, like in zip(lay, grads, ins):
                assert isinstance(g, DTensor) and g.shape == like.shape
                if world == 1:      # any layout is the whole tensor there
                    continue
                want = Partial() if name in partial else lay[name]
                assert all(p == want for p in g.placements), (name,
                                                              g.placements)


def test_backward_launcher_rejects_what_the_kernels_do_not_take():
    """The backward launcher checks the cotangents' shapes, then runs the
    forward's checks, before it builds anything; CPU tensors raise."""
    arrays = _arrays(1, 48, 2, 16, 32, seed=1, decay="fast",
                     gstate="nonzero")
    x, dt, A, Bm, Cm, gy, gs = (torch.from_numpy(a) for a in arrays)
    with pytest.raises(ValueError, match="gy"):
        tk.ssd_scan_backward(x, dt, A, Bm, Cm, gy[:, :32], gs, 16)
    with pytest.raises(ValueError, match="gstate"):
        tk.ssd_scan_backward(x, dt, A, Bm, Cm, gy, gs[..., :16], 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tk.ssd_scan_backward(x[:, :40], dt[:, :40], A, Bm[:, :40],
                             Cm[:, :40], gy[:, :40], gs, 16)
    with pytest.raises(ValueError, match="chunk 24"):
        tk.ssd_scan_backward(x, dt, A, Bm, Cm, gy, gs, 24)
    x80 = torch.zeros((1, 48, 2, 80))
    with pytest.raises(ValueError, match="P=80"):
        tk.ssd_scan_backward(x80, dt, A, Bm, Cm, torch.zeros_like(x80),
                             torch.zeros((1, 2, 80, 32)), 16)
    with pytest.raises(ValueError, match="float32"):
        tk.ssd_scan_backward(x, dt.double(), A, Bm, Cm, gy, gs, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tk.ssd_scan_backward(x, dt, A, Bm, Cm, gy, gs, 16)


@pytest.mark.parametrize("dims,route,groups", [
    # the redesigned passes: the fewest groups that make (waves of
    # WAVE_CTAS CTAs) x (heads a group + WAVE_CTA_HEADS) least
    ((8, 2048, 32, 256), "wgmma", 1),   # mamba2-370m's step: 128 CTAs
    ((8, 4096, 32, 256), "wgmma", 1),   # phase 6's table shape: 256
    ((2, 512, 32, 256), "wgmma", 16),   # 8 CTAs a group: 16 groups of 2
    ((5, 1024, 5, 256), "wgmma", 3),    # 5 heads in 3 groups (2, 2, 1)
    ((25, 1024, 2, 256), "wgmma", 1),   # 200 CTAs: a ragged second wave
    # the mma.sync passes: the fewest groups that give GROUP_CTAS CTAs
    ((8, 2048, 32, 256), "tiles", 2),
    ((8, 4096, 32, 256), "tiles", 1),
    ((1, 64, 3, 16), "tiles", 3),       # few CTAs: one head a group
    ((1, 960, 24, 16), "tiles", 5),     # 24 heads in groups of 5 (last 4)
])
def test_head_groups_follow_the_shapes(dims, route, groups):
    """The backward splits a chunk's heads into groups by its route's rule,
    as equal as whole heads allow; the shapes alone decide."""
    B, T, H, chunk = dims
    assert tk.head_groups(B, T, H, chunk, route) == groups
    per = -(-H // groups)
    assert -(-H // per) == groups and groups <= H
    if route == "wgmma":
        items = B * (T // chunk) * tk.wgmma_folds(chunk)
        cost = [-(-items * g // tk.WAVE_CTAS) * (-(-H // g)
                                                 + tk.WAVE_CTA_HEADS)
                for g in range(1, H + 1)]
        assert cost[groups - 1] == min(cost)
        assert all(c > min(cost) for c in cost[:groups - 1])


@pytest.mark.parametrize("dtype,P,N,chunk,route", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),    # mamba2's widths
    (torch.bfloat16, 64, 64, 64, "wgmma"),
    (torch.bfloat16, 64, 128, 192, "wgmma"),
    (torch.bfloat16, 64, 128, 32, "tiles"),     # chunk not a multiple of 64
    (torch.bfloat16, 48, 128, 256, "tiles"),    # P outside the boxes
    (torch.bfloat16, 64, 96, 256, "tiles"),     # N outside the boxes
    (torch.float32, 64, 128, 256, "tiles"),     # float32: the CUDA cores
])
def test_backward_route_follows_shape_and_dtype(dtype, P, N, chunk, route):
    """The launcher's dispatch: the redesigned passes for bfloat16 at P 64,
    N 64 or 128 and chunks a multiple of 64; the mma.sync ones otherwise."""
    assert tk.backward_route(dtype, P, N, chunk) == route
