"""The port's chunked-SSD plain version against the JAX package's Pallas
kernel (interpret mode) on the CPU, and the CUDA wrapper's checks.

Inputs are made with numpy from a seed and handed to both.  Tolerances are
the reference's own: 1e-4 in float32, 5e-2 in bfloat16, on y and on the
final state.

The bfloat16 CUDA kernel cannot run here, so its arithmetic is rehearsed
tile by tile in torch (:func:`emulate_bf16_ssd_kernel`) and held to the
Pallas kernel: its tile sizes and key tiles j <= i, the decay factored
into per-row and per-column tables off the diagonal, the mask on the
diagonal tile only, the warp-scan order of the cumsum, and W, x·w and the
state operand rounded to bfloat16.  Beside the elementwise limit, the
relative RMS error ``||got - want|| / ||want||`` must be at most 1e-2.

Two decay regimes: "fast" (dt = softplus(randn), A = -exp(0.3 randn), the
reference's test inputs; dt·A is about -0.7 a step, so a key tile more
than one tile back contributes nothing measurable) and "slow" (Mamba-2's
published init: dt log-uniform in [1e-3, 1e-1], A = -U(1, 16)), where
every key tile of a chunk reaches its later rows and a dropped tile shows.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402

# (B, T, H, P, N, chunk, dtype): tests/test_kernels.py
SSD_CASES = [
    (2, 128, 4, 32, 64, 32, "float32"),
    (1, 256, 8, 64, 128, 64, "float32"),
    (1, 128, 2, 16, 32, 16, "bfloat16"),
]


def _inputs(B, T, H, P, N, seed=0, decay="fast"):
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
    return x, dt, A, Bm, Cm


def _both(arrays, dtype):
    x, dt, A, Bm, Cm = arrays
    jx = (jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(A),
          jnp.asarray(Bm).astype(dtype), jnp.asarray(Cm).astype(dtype))
    td = getattr(torch, dtype)
    tx = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
          torch.from_numpy(A), torch.from_numpy(Bm).to(td),
          torch.from_numpy(Cm).to(td))
    return jx, tx


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_version_matches_pallas_kernel(case):
    B, T, H, P, N, chunk, dtype = case
    jx, tx = _both(_inputs(B, T, H, P, N), dtype)
    y, st = ssd_scan(*jx, chunk, interpret=True)
    ty, tst = ops.ssd(*tx, chunk=chunk)
    assert ty.dtype == tst.dtype == tx[0].dtype
    assert tuple(ty.shape) == (B, T, H, P)
    assert tuple(tst.shape) == (B, H, P, N)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for got, want in ((ty, y), (tst, st)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_state_feeds_decode():
    """The final state equals the reference's, so a prefill through the
    kernel hands off to the recurrent decode path (test_kernels.py's
    state-feeds-decode case), and a state carried in continues the scan."""
    B, T, H, P, N, chunk = 1, 64, 2, 16, 32, 16
    jx, tx = _both(_inputs(B, T, H, P, N, seed=1), "float32")
    _, st_k = ssd_scan(*jx, chunk, interpret=True)
    _, st_t = ops.ssd(*tx, chunk=chunk)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_k), atol=1e-5)
    # two halves with the state carried across == one pass
    half = T // 2
    first = [t[:, :half] if t.dim() > 1 else t for t in tx]
    second = [t[:, half:] if t.dim() > 1 else t for t in tx]
    _, mid = ssd_ref(*first, chunk)
    y2, st2 = ssd_ref(*second, chunk, init_state=mid)
    jy2, jst2 = jssd_ref(*[jnp.asarray(t.numpy()) for t in second], chunk,
                         init_state=jnp.asarray(mid.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-5)
    np.testing.assert_allclose(st2.numpy(), np.asarray(jst2), atol=1e-5)
    np.testing.assert_allclose(st2.numpy(), st_t.numpy(), atol=1e-5)


@pytest.mark.parametrize("per", [1, 3])
def test_plain_version_carries_the_state_across_blocks(monkeypatch, per):
    """``ssd_ref`` split into blocks of ``per`` chunks (8 chunks: every
    chunk its own block, or blocks of 3, 3 and a partial 2), from a
    carried-in state: y, the final state and the VJP of both with respect
    to every input and the initial state equal the JAX package's
    ``ssd_scan_ref`` within 1e-5."""
    import jax

    from repro.models.ssd import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ref as tref
    B, T, H, P, N, chunk = 1, 128, 2, 16, 32, 16
    monkeypatch.setattr(tref, "BLOCK_ELEMS", per * B * H * chunk * chunk)
    blocks = []
    segsum = tref._segsum
    monkeypatch.setattr(tref, "_segsum",
                        lambda a: blocks.append(a.shape[1]) or segsum(a))
    arrays = _inputs(B, T, H, P, N, seed=3)
    rng = np.random.default_rng(4)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    cy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    cst = rng.standard_normal((B, H, P, N)).astype(np.float32)

    ins = [torch.from_numpy(a).requires_grad_() for a in (*arrays, h0)]
    y, st = tref.ssd_ref(*ins[:5], chunk, init_state=ins[5])
    grads = torch.autograd.grad((y, st), ins,
                                (torch.from_numpy(cy), torch.from_numpy(cst)))
    assert blocks == ([1] * 8 if per == 1 else [3, 3, 2])

    (jy, jst), vjp = jax.vjp(
        lambda x, dt, A, Bm, Cm, h: ssd_scan_ref(x, dt, A, Bm, Cm, chunk, h),
        *[jnp.asarray(a) for a in (*arrays, h0)])
    jgrads = vjp((jnp.asarray(cy), jnp.asarray(cst)))
    for name, got, want in (("y", y, jy), ("state", st, jst),
                            *zip(("dx", "ddt", "dA", "dB", "dC", "dh0"),
                                 grads, jgrads)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dims,chunk,match", [
    ((1, 48, 2, 16, 32), 16, "CUDA"),          # valid shapes, CPU tensors
    ((1, 40, 2, 16, 32), 16, "multiple of chunk"),
    ((1, 48, 2, 24, 32), 16, "P=24"),
    ((1, 48, 2, 80, 32), 16, "P=80"),
    ((1, 48, 2, 16, 144), 16, "N=144"),
    ((1, 48, 2, 16, 40), 16, "N=40"),
    ((1, 48, 2, 16, 32), 24, "chunk 24"),
    ((1, 512, 2, 16, 32), 512, "chunk 512"),
])
def test_kernel_wrapper_rejects(dims, chunk, match):
    """The CUDA wrapper checks before it builds anything."""
    _, tx = _both(_inputs(*dims), "float32")
    with pytest.raises(ValueError, match=match):
        tk.ssd_scan(*tx, chunk)


def test_kernel_wrapper_rejects_dtypes():
    _, (x, dt, A, Bm, Cm) = _both(_inputs(1, 32, 2, 16, 16), "float32")
    with pytest.raises(ValueError, match="float32"):
        tk.ssd_scan(x, dt.double(), A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="dtype"):
        tk.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, 16)


def test_kernel_wrapper_rejects_misaligned_bf16():
    """The tensor-core kernel's 16-B cp.async loads need x, B and C to
    start 16-B aligned with strides in multiples of 8 elements: a view
    that breaks either raises instead of being read wrong."""
    _, (x, dt, A, Bm, Cm) = _both(_inputs(1, 32, 2, 16, 32), "bfloat16")
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-B aligned"):
        tk.ssd_scan(flat[1:].view(x.shape), dt, A, Bm, Cm, 16)
    wide = torch.zeros((1, 32, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-B aligned"):
        tk.ssd_scan(x, dt, A, wide, Cm, 16)
    with pytest.raises(ValueError, match="16-B aligned"):
        tk.ssd_scan(x, dt, A, Bm, wide, 16)
    # aligned bfloat16 views pass on to the device check
    with pytest.raises(ValueError, match="CUDA"):
        tk.ssd_scan(x, dt, A, Bm, Cm, 16)


# -- the bfloat16 tensor-core kernel, tile by tile ------------------------------

RMS_LIMIT = 1e-2
#: the negative control's missing tile pair (output tile, key tile): rows
#: 192-255 against keys 128-191 of every chunk.  The adjacent key tile is
#: the one every A of the slow init reaches; two tiles back (keys 64-127)
#: falls under the limit for some draws of A (4.2e-3 at H=32, seed 1).
DROPPED = (3, 2)


def kernel_tile(chunk):
    """Rows of the bf16 kernel's output and key tiles."""
    return 64 if chunk % 64 == 0 else (32 if chunk % 32 == 0 else 16)


def warp_scan_cumsum(dA):
    """cumsum over the last axis in the kernel's order: each of 32 lanes
    sums E = ceil(L / 32) consecutive steps in order, a Hillis-Steele scan
    adds the lane totals (step ``off``: lane += lane - off, for lanes >=
    off, all at once), and each lane adds its exclusive prefix."""
    L = dA.shape[-1]
    E = -(-L // 32)
    pad = torch.zeros(dA.shape[:-1] + (32 * E,), dtype=torch.float32)
    pad[..., :L] = dA
    lanes = pad.reshape(dA.shape[:-1] + (32, E))
    run = torch.empty_like(lanes)
    acc = torch.zeros(lanes.shape[:-1])
    for k in range(E):
        acc = acc + lanes[..., k]
        run[..., k] = acc
    incl, lane, off = acc, torch.arange(32), 1
    while off < 32:
        shifted = torch.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = torch.where(lane >= off, incl + shifted, incl)
        off *= 2
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    return (excl[..., None] + run).reshape(pad.shape)[..., :L]


def emulate_bf16_ssd_kernel(x, dt, A, Bm, Cm, chunk, drop_tile=None):
    """The bfloat16 kernel's arithmetic in torch: x (B,T,H,P), Bm/Cm
    (B,T,N) bfloat16, dt (B,T,H), A (H,) float32 → (y, final state) in
    bfloat16.  ``drop_tile`` = (output tile, key tile) skips that pair in
    every chunk (the negative control)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    L, TL = chunk, kernel_tile(chunk)
    xf, bf, cf = x.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, P, N))
    y = torch.empty((Bsz, T, H, P), dtype=torch.bfloat16)
    rows = torch.arange(TL)
    for t0 in range(0, T, L):
        dtc = dt[:, t0:t0 + L].float().transpose(1, 2)          # (B,H,L)
        cs = warp_scan_cumsum(dtc * A[:, None])
        h_op = h.bfloat16().float()             # the state operand
        last = cs[..., -1:]
        first_of_tile = cs[..., ::TL].repeat_interleave(TL, -1)
        last_of_tile = cs[..., TL - 1::TL].repeat_interleave(TL, -1)
        ecs = torch.exp(cs)
        wst = torch.exp(last - cs) * dtc
        rin = torch.exp(cs - first_of_tile)
        rout = torch.exp(last_of_tile - cs) * dtc
        h = h * torch.exp(last)[..., None]
        xc = xf[:, t0:t0 + L].transpose(1, 2)                   # (B,H,L,P)
        bc, cc = bf[:, None, t0:t0 + L], cf[:, None, t0:t0 + L]
        for it in range(L // TL):
            i0 = it * TL
            ci = cc[:, :, i0:i0 + TL]
            yi = (ci @ h_op.transpose(-1, -2)) * ecs[..., i0:i0 + TL, None]
            for jt in range(it + 1):
                if (it, jt) == drop_tile:
                    continue
                j0 = jt * TL
                s = ci @ bc[:, :, j0:j0 + TL].transpose(-1, -2)
                if jt < it:     # exp(cs_i - cs_i0) exp(cs_i0 - cs_j1) ...
                    ex = torch.exp(cs[..., i0] - cs[..., j0 + TL - 1])
                    col = ex[..., None] * rout[..., j0:j0 + TL]
                    w = s * rin[..., i0:i0 + TL, None] * col[..., None, :]
                else:           # the diagonal: per element, masked
                    c = cs[..., i0:i0 + TL]
                    w = (s * torch.exp(c[..., :, None] - c[..., None, :])
                         * dtc[..., None, j0:j0 + TL])
                    w = torch.where(rows[None, :] <= rows[:, None], w,
                                    torch.zeros(()))
                yi = yi + w.bfloat16().float() @ xc[..., j0:j0 + TL, :]
            y[:, t0 + i0:t0 + i0 + TL] = yi.transpose(1, 2).bfloat16()
        xw = (xc * wst[..., None]).bfloat16().float()
        h = h + xw.transpose(-1, -2) @ bc
    return y, h.bfloat16()


def rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


# (B, T, H, P, N, chunk): the bfloat16 case of SSD_CASES (16-row tiles),
# 32-row tiles, odd P and N, and mamba2's widths (P=64, N=128, chunk 256)
BF16_CASES = [c[:6] for c in SSD_CASES if c[-1] == "bfloat16"] + [
    (1, 256, 2, 32, 64, 32),
    (2, 192, 2, 48, 80, 64),
    (1, 512, 8, 64, 128, 256),
]


@pytest.mark.parametrize("decay", ["fast", "slow"])
@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_emulation_matches_pallas_kernel(case, decay):
    B, T, H, P, N, chunk = case
    jx, tx = _both(_inputs(B, T, H, P, N, seed=T + P, decay=decay),
                   "bfloat16")
    y, st = ssd_scan(*jx, chunk, interpret=True)
    got_y, got_st = emulate_bf16_ssd_kernel(*tx, chunk)
    assert got_y.dtype == got_st.dtype == torch.bfloat16
    assert tuple(got_y.shape) == (B, T, H, P)
    assert tuple(got_st.shape) == (B, H, P, N)
    for got, want in ((got_y, y), (got_st, st)):
        want = torch.from_numpy(np.asarray(want, np.float32))
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=5e-2, rtol=5e-2)
        assert rel_rms(got, want) <= RMS_LIMIT


def test_rel_rms_check_catches_a_dropped_tile():
    """Negative control under slow decay: the emulated kernel passes the
    checks against ssd_ref, and fails them with tile pair (3, 2) dropped
    in every chunk.  Under fast decay a tile two back (pair (3, 1)) goes
    unseen, the blind spot that the slow-decay cases close."""
    B, T, H, P, N, chunk = 1, 1024, 16, 64, 128, 256
    _, tx = _both(_inputs(B, T, H, P, N, seed=5, decay="slow"), "bfloat16")
    want, _ = ssd_ref(*tx, chunk)
    whole, _ = emulate_bf16_ssd_kernel(*tx, chunk)
    dropped, _ = emulate_bf16_ssd_kernel(*tx, chunk, drop_tile=DROPPED)
    assert rel_rms(whole, want) <= RMS_LIMIT < rel_rms(dropped, want)
    assert float((dropped.float() - want.float()).abs().max()) > 5e-2
    _, fast = _both(_inputs(B, T, 4, P, N, seed=5), "bfloat16")
    fwant, _ = ssd_ref(*fast, chunk)
    fdropped, _ = emulate_bf16_ssd_kernel(*fast, chunk, drop_tile=(3, 1))
    assert rel_rms(fdropped, fwant) <= RMS_LIMIT
