"""The port's flash-attention plain version against the JAX package's
Pallas kernel (interpret mode) on the CPU, and the CUDA wrapper's checks.

Inputs are made with numpy from a seed and handed to both; bfloat16 inputs
are the same float32 values rounded by each framework (round to nearest
even, so the bits agree).  Tolerances are the reference's own: 3e-5 in
float32, 2e-2 in bfloat16.

The bfloat16 CUDA kernel cannot run here, so its arithmetic is rehearsed
tile by tile in torch (:func:`emulate_bf16_kernel`) and held to the Pallas
kernel: its tile sizes and kv range, masks only on the tiles that straddle
the diagonal, the window's edge or the kv tail, ``exp2`` with log2(e)
folded into the scale, and P rounded to bfloat16 before P·V.  Beside the
elementwise limit, the relative RMS error ``||got - want|| / ||want||``
must be at most 1e-2: bfloat16 output rounding alone gives about 1e-3, a
skipped 64-key tile about 1e-1 (the negative control below).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# (B, H, KV, S, hd, causal, window, softcap, dtype): tests/test_kernels.py
FLASH_CASES = [
    (1, 4, 2, 256, 64, True, None, 0.0, "float32"),
    (2, 4, 4, 128, 32, True, 64, 0.0, "float32"),
    (1, 2, 1, 192, 64, False, None, 0.0, "float32"),   # MQA + kv padding
    (1, 4, 2, 256, 64, True, None, 30.0, "float32"),   # softcap (gemma2)
    (1, 2, 2, 320, 128, True, 128, 50.0, "float32"),
    (1, 4, 2, 256, 64, True, None, 0.0, "bfloat16"),
    (1, 8, 2, 384, 128, True, None, 0.0, "bfloat16"),  # GQA group 4
]


def _inputs(case, seed=0):
    B, H, KV, S, hd, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_version_matches_pallas_kernel(case):
    B, H, KV, S, hd, causal, window, cap, dtype = case
    arrays = _inputs(case)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    want = flash_attention(*jx, causal=causal, window=window, softcap=cap,
                           block_q=128, block_k=128, interpret=True)
    got = ops.attention(*tx, causal=causal, window=window, softcap=cap)
    assert got.dtype == tx[0].dtype and tuple(got.shape) == (B, H, S, hd)
    tol = 3e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_plain_version_takes_strided_views():
    """The model hands (B, S, H, hd) projections over as (B, H, S, hd)
    views; the result must not depend on the layout."""
    q, k, v = _inputs((2, 4, 2, 96, 32))
    tq, tk_, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = attention_ref(tq, tk_, tv, causal=True)
    got = attention_ref(*(t.transpose(1, 2).contiguous().transpose(1, 2)
                          for t in (tq, tk_, tv)), causal=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 8, 48), (1, 2, 8, 48)), "head dim"),
    (((1, 4, 8, 300), (1, 2, 8, 300)), "head dim"),
    (((1, 4, 8, 320), (1, 2, 8, 320)), "CUDA"),
    (((1, 4, 8, 64), (1, 3, 8, 64)), "kv heads"),
    (((1, 4, 8, 64), (1, 2, 8, 32)), "must be"),
    (((1, 4, 8, 64), (1, 2, 8, 64)), "CUDA"),
])
def test_kernel_wrapper_rejects(shapes, match):
    """The CUDA wrapper checks before it builds anything: what the kernel
    cannot take, and a CPU tensor, raise ValueError."""
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        tk.flash_attention(q, k, k)


def test_kernel_wrapper_rejects_dtypes():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tk.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="dtype"):
        tk.flash_attention(q.float(), q.bfloat16(), q.bfloat16())


def test_kernel_wrapper_rejects_misaligned_bf16():
    """The tensor-core kernel's 16-B cp.async loads need an aligned start
    and (b, h, s) strides in multiples of 8 elements: a view that breaks
    either raises instead of being copied quietly."""
    base = torch.zeros((1, 2, 9, 64), dtype=torch.bfloat16)
    ok = base[:, :, :8]
    with pytest.raises(ValueError, match="16-B aligned"):
        tk.flash_attention(base.flatten()[1:1 + ok.numel()].view(ok.shape),
                           ok, ok)
    wide = torch.zeros((1, 2, 8, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-B aligned"):
        tk.flash_attention(ok, wide, wide)
    # aligned bfloat16 views pass on to the device check
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention(ok, ok, ok)


# -- the bfloat16 tensor-core kernel, tile by tile ------------------------------

LOG2E = 1.4426950408889634
RMS_LIMIT = 1e-2


def kernel_tiles(hd, softcap):
    """(q rows a CTA, q rows a warp, kv rows a tile) of the bf16 kernel: 4
    warps of two m16 row tiles at hd=128 without softcap, else of one; kv
    tiles of 32 rows at hd=256, else 64."""
    wr = 32 if hd == 128 and softcap <= 0 else 16
    return 4 * wr, wr, 32 if hd == 256 else 64


def emulate_bf16_kernel(q, k, v, *, causal, window, softcap, scale=None,
                        drop_tile=None):
    """The bfloat16 kernel's arithmetic in torch: q (B, H, Sq, hd), k/v
    (B, KV, Skv, hd) bfloat16 → (B, H, Sq, hd) bfloat16.  ``drop_tile``
    skips one kv tile (the negative control)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    BQ, WR, BK = kernel_tiles(hd, softcap)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    nq, nk = -(-Sq // BQ), -(-Skv // BK)
    # rows past Sq and kv rows past Skv are zero-filled, as cp.async does
    qp = torch.zeros((B, H, nq * BQ, hd))
    qp[:, :, :Sq] = q.float()
    kp = torch.zeros((B, KV, nk * BK, hd))
    vp = torch.zeros((B, KV, nk * BK, hd))
    kp[:, :, :Skv], vp[:, :, :Skv] = k.float(), v.float()
    kp = kp.repeat_interleave(H // KV, dim=1)
    vp = vp.repeat_interleave(H // KV, dim=1)
    out = torch.empty((B, H, nq * BQ, hd))
    for qt in range(nq):
        q0 = qt * BQ
        q_last = min(q0 + BQ, Sq) - 1
        kt_end = min(nk, q_last // BK + 1) if causal else nk
        kt_begin = ((q0 - window + 1) // BK
                    if window is not None and q0 - window + 1 > 0 else 0)
        qi = torch.arange(q0, q0 + BQ)[:, None]
        qtile = qp[:, :, q0:q0 + BQ]
        m = torch.full((B, H, BQ), -1e30)
        l = torch.zeros((B, H, BQ))
        acc = torch.zeros((B, H, BQ, hd))
        for kt in range(kt_begin, kt_end):
            if kt == drop_tile:
                continue
            k0 = kt * BK
            s = qtile @ kp[:, :, k0:k0 + BK].transpose(-1, -2)
            if softcap > 0:
                s = torch.tanh(s * scale / softcap) * softcap * LOG2E
            else:
                s = s * sl2
            kj = torch.arange(k0, k0 + BK)[None, :]
            keep = kj < Skv
            if causal:
                keep = keep & (kj <= qi)
            if window is not None:
                keep = keep & (qi - kj < window)
            # each warp masks only where its rows straddle an edge
            for w in range(BQ // WR):
                qw = q0 + WR * w
                edge = (k0 + BK > Skv or (causal and k0 + BK - 1 > qw)
                        or (window is not None
                            and qw + WR - 1 - k0 >= window))
                if not edge:
                    keep[WR * w:WR * (w + 1)] = True
            s = s.masked_fill(~keep, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + p.bfloat16().float() @ vp[:, :, k0:k0 + BK])
            m = m_new
        out[:, :, q0:q0 + BQ] = acc / l.clamp_min(1e-30)[..., None]
    return out[:, :, :Sq].bfloat16()


def rel_rms(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


# (B, H, KV, Sq, Skv, hd, causal, window, softcap): the bfloat16 cases of
# FLASH_CASES, then window, softcap, kv tail, MQA, Sq != Skv, hd 32 and 256
BF16_CASES = [c[:4] + c[3:8] for c in FLASH_CASES if c[-1] == "bfloat16"] + [
    (2, 4, 4, 128, 128, 32, True, 64, 0.0),     # window, hd 32
    (1, 4, 2, 256, 256, 64, True, None, 30.0),  # softcap
    (1, 2, 2, 320, 320, 128, True, 128, 50.0),  # window + softcap + kv tail
    (1, 2, 2, 320, 320, 128, True, 80, 0.0),   # 32-row warps, window
    (1, 4, 2, 70, 200, 128, False, None, 0.0),  # 32-row warps, tails
    (1, 2, 1, 192, 192, 64, False, None, 0.0),  # MQA + kv tail
    (1, 2, 1, 70, 192, 64, False, None, 0.0),   # Sq != Skv
    (1, 2, 2, 192, 192, 256, True, None, 0.0),  # hd 256: 32-row kv tiles
    (1, 2, 2, 130, 130, 256, True, 100, 0.0),   # hd 256, window, q/kv tails
]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_emulation_matches_pallas_kernel(case):
    B, H, KV, Sq, Skv, hd, causal, window, cap = case
    rng = np.random.default_rng(Sq + Skv + hd)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, Sq, hd), (B, KV, Skv, hd),
                            (B, KV, Skv, hd))]
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    want = flash_attention(*jx, causal=causal, window=window, softcap=cap,
                           block_q=128, block_k=128, interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32))
    got = emulate_bf16_kernel(*tx, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, Sq, hd)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
    assert rel_rms(got, want) <= RMS_LIMIT


def test_rel_rms_check_catches_a_dropped_tile():
    """Negative control: at S=1024 the emulated kernel passes the relative
    RMS check against attention_ref, and fails it with one middle kv tile
    of 64 keys dropped."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((1, 2, 1024, 64), (1, 1, 1024, 64),
                                         (1, 1, 1024, 64)))
    want = attention_ref(q, k, v, causal=True)
    whole = rel_rms(emulate_bf16_kernel(q, k, v, causal=True, window=None,
                                        softcap=0.0), want)
    dropped = rel_rms(emulate_bf16_kernel(q, k, v, causal=True, window=None,
                                          softcap=0.0, drop_tile=8), want)
    assert whole <= RMS_LIMIT < dropped


def _twin(q, k, v, causal, window, softcap, scale):
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


# (hd, causal, window, softcap): GQA 4 over 2 kv heads throughout
PADDED_CASES = [(8, True, None, 0.0), (16, True, None, 30.0),
                (24, True, 24, 0.0), (48, False, None, 50.0),
                (80, True, 40, 30.0), (96, True, None, 0.0),
                (200, True, 64, 0.0)]


@pytest.mark.parametrize("case", PADDED_CASES)
def test_padded_route_equals_the_unpadded_twin(case):
    """The route a CUDA tensor of a head dim the kernel is not built for
    takes (zero-pad q, k and v to the next built head dim, pass the
    unpadded scale, slice the output), with the plain twin standing in for
    the kernel: values and q/k/v gradients equal the twin at the unpadded
    width within 1e-6 (float32)."""
    hd, causal, window, cap = case
    rng = np.random.default_rng(hd)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((2, 4, 72, hd), (2, 2, 72, hd), (2, 2, 72, hd))]
    cot = torch.from_numpy(rng.standard_normal((2, 4, 72, hd))
                           .astype(np.float32))
    outs = []
    for route in (lambda *a: ops.pad_to_kernel(_twin, *a), _twin):
        x = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = route(*x, causal, window, cap, None)
        assert tuple(out.shape) == (2, 4, 72, hd)
        outs.append((out.detach(), *torch.autograd.grad(out, x, cot)))
    for got, want, what in zip(outs[0], outs[1], ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=what)


@pytest.mark.parametrize("hd,kernel_hd", [(16, 32), (8, 32), (48, 64),
                                          (96, 128), (200, 256), (64, 64),
                                          (300, 320), (320, 320),
                                          (512, 512)])
def test_dispatcher_sends_other_head_dims_to_the_kernel_padded(
        monkeypatch, hd, kernel_hd):
    """On meta tensors (the CUDA route's shapes) the dispatcher hands the
    kernel's Function head dim ``kernel_hd`` with the unpadded scale, and
    returns ``hd`` wide; never the plain twin."""
    seen = []

    class Recorder:
        @staticmethod
        def apply(q, k, v, causal, window, softcap, scale):
            seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
            return ops.flash_attention_op(q, k, v, causal, window, softcap,
                                          scale)

    monkeypatch.setattr(ops, "KernelAttention", Recorder)
    monkeypatch.setattr(ops, "attention_ref", None)
    q = torch.empty((2, 4, 40, hd), device="meta")
    k = torch.empty((2, 2, 40, hd), device="meta")
    out = ops.attention(q, k, k, causal=True)
    assert tuple(out.shape) == (2, 4, 40, hd)
    want_scale = None if hd == kernel_hd else 1.0 / math.sqrt(hd)
    assert seen == [(kernel_hd,) * 3 + (want_scale,)]


def test_padded_head_dim_and_its_limit():
    """Up to 256 the next built head dim; above it there is no limit: the
    next multiple of 32, which the kernels run as slices of built widths
    (320 = 256 + 64)."""
    assert [ops.padded_head_dim(d) for d in (1, 16, 32, 33, 200, 256)] == \
        [32, 32, 32, 64, 256, 256]
    assert [ops.padded_head_dim(d) for d in (257, 300, 320, 512, 1000)] == \
        [288, 320, 320, 512, 1024]


def test_padded_route_keeps_a_dtensors_layout():
    """Meta DTensors of head dim 16 on a fake (2, 2) mesh, batch-sharded
    over "data" and head-sharded over "model": the dispatcher pads them by
    concatenation, the kernel's op runs on shards of head dim 32, and the
    output is a DTensor of head dim 16 in the inputs' layout."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.kernels import cost
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        lay = [Shard(0), Shard(1)]
        q = distribute_tensor(torch.empty((4, 4, 64, 16), device="meta"),
                              mesh, lay)
        k = distribute_tensor(torch.empty((4, 2, 64, 16), device="meta"),
                              mesh, lay)
        out, t = op_analysis.count(ops.attention, q, k, k, causal=True,
                                   mesh=mesh)
        assert isinstance(out, DTensor) and tuple(out.placements) == \
            tuple(lay)
        assert tuple(out.shape) == (4, 4, 64, 16)
        assert tuple(out.to_local().shape) == (2, 2, 64, 16)
        assert t.kernel_calls == {"flash_attention": 1}
        # each rank's call: 2 rows, 2 heads over 1 kv head, at head dim 32
        assert t.flops == cost.flash_attention_cost(
            2, 2, 1, 64, 64, 32, True, None, 4)[0]
