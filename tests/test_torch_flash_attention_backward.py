"""The port's flash-attention backward on the CPU: its plain twins
(``attention_lse_ref``, ``attention_bwd_ref``) against ``jax.vjp`` of the
JAX package's ``kernels/flash_attention/ref.py::attention_ref``, the bf16
backward kernel's roundings emulated in torch, and the custom ops' fake
implementations, sharding rules and dry-run costs on meta tensors.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 within 1e-4 of each gradient's max |grad| (the same
function, its sums in another order); the bf16 kernel's emulation, which
rounds P to bfloat16 before P^T.dO and dS before dS^T.q and dS.k, within
2e-2 of max |grad| and relative RMS ``||got - want|| / ||want||`` at most
1e-2, the forward's bf16 limits.

The CUDA kernels cannot run here; ``tests/test_torch_cuda.py`` holds them
to these twins on the card, and ``chip_smoke.py`` phase 5 at the models'
shapes.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as jattention  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref)
from repro_torch.launch import op_analysis  # noqa: E402

F32_TOL = 1e-4
BF16_TOL, RMS_LIMIT = 2e-2, 1e-2

# (B, H, KV, Sq, Skv, hd, causal, window, softcap): causal and not, a
# window, softcap 30 and 50, GQA groups 1, 2 and 16, Sq != Skv both ways,
# lengths that are not multiples of 64, hd 16 through 320
CASES = [
    (1, 4, 2, 64, 64, 32, True, None, 0.0),
    (2, 4, 4, 100, 100, 16, True, 24, 0.0),
    (1, 2, 1, 70, 150, 64, False, None, 0.0),
    (1, 4, 2, 96, 96, 64, True, None, 30.0),
    (1, 2, 2, 130, 130, 128, True, 40, 50.0),
    (1, 16, 1, 80, 80, 256, True, 32, 0.0),
    (1, 4, 2, 90, 40, 32, True, None, 0.0),
    (1, 4, 2, 50, 90, 320, False, None, 0.0),
    (1, 16, 1, 33, 33, 320, True, None, 50.0),
]


def _arrays(case, seed):
    B, H, KV, Sq, Skv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Skv, hd), (B, KV, Skv, hd),
                      (B, H, Sq, hd))]


def _jax_vjp(q, k, v, dout, causal, window, softcap):
    """(out, (dq, dk, dv)) of the JAX package's attention_ref, float32."""
    out, vjp = jax.vjp(lambda a, b, c: jattention(
        a, b, c, causal=causal, window=window, softcap=softcap),
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _share(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES)
def test_backward_twin_equals_jax_vjp(case):
    """attention_bwd_ref from attention_lse_ref's output and log-sum-exp
    equals jax.vjp of the reference's attention_ref (float32)."""
    B, H, KV, Sq, Skv, hd, causal, window, cap = case
    q, k, v, dout = _arrays(case, seed=Sq + Skv + hd)
    jout, jgrads = _jax_vjp(q, k, v, dout, causal, window, cap)
    tx = [torch.from_numpy(a) for a in (q, k, v, dout)]
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = attention_lse_ref(*tx[:3], **kw)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Sq)
    np.testing.assert_allclose(out.numpy(), jout, atol=3e-5, rtol=3e-5)
    grads = attention_bwd_ref(*tx[:3], out, lse, tx[3], **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _share(g.numpy(), w) <= F32_TOL, (name, _share(g.numpy(), w))


@pytest.mark.parametrize("case", CASES[:4])
def test_lse_twin_is_the_rows_logsumexp(case):
    """attention_lse_ref's log-sum-exp is that of the reference's scaled,
    softcapped, masked scores (numpy, float64), and its output is
    attention_ref's (P as exp(s - lse) instead of a softmax: float32
    rounding apart)."""
    B, H, KV, Sq, Skv, hd, causal, window, cap = case
    q, k, v, _ = _arrays(case, seed=7)
    kw = dict(causal=causal, window=window, softcap=cap)
    tx = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = attention_lse_ref(*tx, **kw)
    torch.testing.assert_close(out, attention_ref(*tx, **kw), atol=1e-6,
                               rtol=1e-6)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) / math.sqrt(hd),
                  np.repeat(k.astype(np.float64), H // KV, axis=1))
    if cap > 0:
        s = np.tanh(s / cap) * cap
    qi, kj = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= qi - kj < window
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def emulate_bf16_backward(q, k, v, out, lse, dout, *, causal, window,
                          softcap, scale=None):
    """The bf16 backward kernels' arithmetic in torch, from bfloat16 q, k,
    v, out and dout and the float32 lse: S and dP float32 products of the
    bf16 operands, P = exp(S - lse) (0 where masked), D = rowsum(dout *
    out); P rounded to bf16 before dv = P^T dout, dS = P (dP - D) f rounded
    to bf16 before dk = dS^T q scale and dq = dS k scale; sums float32,
    each gradient rounded to bf16."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    f = torch.ones_like(s)
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s, f = th * softcap, 1 - th * th
    qi = torch.arange(Sq)[:, None]
    kj = torch.arange(Skv)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= qi - kj < window
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * f).bfloat16().float()
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dq = (ds @ kf) * scale

    def by_group(t):
        return t.reshape(B, KV, G, Skv, hd).sum(2)
    return dq.bfloat16(), by_group(dk).bfloat16(), by_group(dv).bfloat16()


@pytest.mark.parametrize("case", CASES)
def test_bf16_kernel_emulation_matches_jax_vjp(case):
    """The bf16 kernels' roundings (the forward's output and lse from
    bfloat16 inputs, P and dS rounded before their products) keep each
    gradient within 2e-2 of max |grad| and 1e-2 relative RMS of jax.vjp of
    the reference at the same bfloat16 values."""
    causal, window, cap = case[6:]
    arrays = [np.asarray(torch.from_numpy(a).bfloat16().float())
              for a in _arrays(case, seed=case[5] + 1)]
    _, jgrads = _jax_vjp(*arrays, causal, window, cap)
    tq, tk_, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = attention_lse_ref(tq, tk_, tv, **kw)
    assert out.dtype == torch.bfloat16
    grads = emulate_bf16_backward(tq, tk_, tv, out, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        got = g.float().numpy()
        assert _share(got, w) <= BF16_TOL, (name, _share(got, w))
        assert _rel_rms(got, w) <= RMS_LIMIT, (name, _rel_rms(got, w))


def test_bf16_emulation_rms_check_catches_a_dropped_tile():
    """Negative control: dropping one 64-key tile from dv's sum takes the
    emulated gradient past the relative-RMS limit that the whole one
    passes."""
    case = (1, 2, 1, 256, 256, 64, True, None, 0.0)
    arrays = [np.asarray(torch.from_numpy(a).bfloat16().float())
              for a in _arrays(case, seed=3)]
    _, (_, _, want) = _jax_vjp(*arrays, True, None, 0.0)
    tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    out, lse = attention_lse_ref(*tx[:3], causal=True)
    dv = emulate_bf16_backward(*tx[:3], out, lse, tx[3], causal=True,
                               window=None, softcap=0.0)[2].float().numpy()
    assert _rel_rms(dv, want) <= RMS_LIMIT
    dropped = dv.copy()
    dropped[:, :, 64:128] = 0.0
    assert _rel_rms(dropped, want) > RMS_LIMIT


# -- the ops on meta tensors (the dry run's route) -----------------------------------


def test_fake_ops_give_the_kernels_shapes():
    """The lse forward's and the backward's fake implementations: the
    output a (B, S, H, hd) buffer's view, lse float32 (B, H, Sq), dq, dk
    and dv (B, S, heads, hd) buffers' views in q's dtype."""
    q = torch.empty((2, 4, 40, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((2, 2, 70, 64), device="meta", dtype=torch.bfloat16)
    out, lse = ops.flash_attention_lse_op(q, k, k, False, None, 0.0, None)
    assert out.shape == q.shape and out.stride() == (40 * 4 * 64, 64,
                                                     4 * 64, 1)
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    dq, dk, dv = ops.flash_attention_backward_op(q, k, k, out, lse, out,
                                                 False, None, 0.0, None)
    assert dq.shape == q.shape and dq.stride() == out.stride()
    for g in (dk, dv):
        assert g.shape == k.shape and g.dtype == torch.bfloat16
        assert g.stride() == (70 * 2 * 64, 64, 2 * 64, 1)


def test_dry_run_charges_the_backward_its_cost():
    """One gradient through the dispatcher on meta tensors: the forward
    with its lse and the backward each run once, charged flash_attention_
    cost (with the lse written) and flash_attention_bwd_cost."""
    q = torch.empty(2, 4, 64, 32, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(2, 2, 64, 32, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)

    def grad():
        out = ops.attention(q, k, k, causal=True, window=16)
        return torch.autograd.grad(out, (q, k), torch.empty_like(out))
    (dq, dk), t = op_analysis.count(grad)
    assert dq.shape == q.shape and dk.shape == k.shape
    assert t.kernel_calls == {"flash_attention_lse": 1,
                              "flash_attention_backward": 1}
    fwd = cost.flash_attention_cost(2, 4, 2, 64, 64, 32, True, 16, 2,
                                    lse=True)
    bwd = cost.flash_attention_bwd_cost(2, 4, 2, 64, 64, 32, True, 16, 2)
    assert t.flops == fwd[0] + bwd[0]
    pairs = cost.attention_pairs(64, 64, True, 16)
    assert bwd[0] == 10 * 32 * pairs * 2 * 4
    assert bwd[1] == 2 * (4 * 2 * 4 * 64 * 32 + 4 * 2 * 2 * 64 * 32) \
        + 4 * 2 * 4 * 64


@pytest.mark.parametrize("hd,kernel_hd", [(320, 320), (300, 320),
                                          (512, 512), (16, 32)])
def test_gradient_route_takes_the_kernel_head_dim(hd, kernel_hd):
    """A head dim the kernels take (above 256: any multiple of 32) reaches
    the lse forward and the backward as it is, any other zero-padded to
    :func:`ops.padded_head_dim`; the gradients come back at the input's
    width."""
    q = torch.empty((1, 4, 24, hd), device="meta", requires_grad=True)
    k = torch.empty((1, 2, 24, hd), device="meta", requires_grad=True)

    def grad():
        out = ops.attention(q, k, k, causal=True)
        return torch.autograd.grad(out, (q, k), torch.empty_like(out))
    with op_analysis.OpCounter() as counter:
        dq, dk = grad()
        seen = counter.totals.kernel_calls
    assert seen == {"flash_attention_lse": 1, "flash_attention_backward": 1}
    assert dq.shape == q.shape and dk.shape == k.shape
    assert counter.totals.flops == (
        cost.flash_attention_cost(1, 4, 2, 24, 24, kernel_hd, True, None, 4,
                                  lse=True)[0]
        + cost.flash_attention_bwd_cost(1, 4, 2, 24, 24, kernel_hd, True,
                                        None, 4)[0])


def test_backward_keeps_a_dtensors_layout():
    """Meta DTensors on a fake (2, 2) mesh, batch-sharded over "data" and
    head-sharded over "model", with gradients: the lse forward and the
    backward run on each rank's shards (one call each), and q's and k's
    gradients are DTensors in the inputs' layout."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, make_mesh
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        lay = [Shard(0), Shard(1)]
        q = distribute_tensor(torch.empty((4, 4, 64, 32), device="meta"),
                              mesh, lay).requires_grad_()
        k = distribute_tensor(torch.empty((4, 2, 64, 32), device="meta"),
                              mesh, lay).requires_grad_()

        def grad():
            out = ops.attention(q, k, k, causal=True)
            return torch.autograd.grad(out, (q, k), torch.ones_like(out))
        (dq, dk), t = op_analysis.count(grad, mesh=mesh)
        for g, like in ((dq, q), (dk, k)):
            assert isinstance(g, DTensor) and tuple(g.placements) == \
                tuple(lay)
            assert g.shape == like.shape
        assert t.kernel_calls == {"flash_attention_lse": 1,
                                  "flash_attention_backward": 1}
        # each rank's calls: 2 rows, 2 heads over 1 kv head
        assert t.flops == cost.flash_attention_cost(
            2, 2, 1, 64, 64, 32, True, None, 4, lse=True)[0] + \
            cost.flash_attention_bwd_cost(2, 2, 1, 64, 64, 32, True, None,
                                          4)[0]


def test_backward_launcher_rejects_what_the_kernels_do_not_take():
    """The backward launcher checks before it builds anything: a head dim
    it does not take, and CPU tensors, raise ValueError."""
    q = torch.zeros((1, 4, 8, 300))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="head dim 300"):
        tk.flash_attention_backward(q, q[:, :2], q[:, :2], q, lse, q)
    q = torch.zeros((1, 4, 8, 320))
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention_backward(q, q[:, :2], q[:, :2], q, lse, q)
    assert tk.kernel_takes_head_dim(320) and tk.kernel_takes_head_dim(512)
    assert not tk.kernel_takes_head_dim(96)
    assert not tk.kernel_takes_head_dim(300)


# -- the fused bf16 kernel's schedule, modelled -------------------------------------
#
# csrc/flash_attention_bwd.cu ``fused``: persistent CTAs claim kv tiles in
# the order t -> (j = t // (B KV), chain t % (B KV)); a tile visits, head by
# head of its group, the 64-row q tiles that reach it; each visit adds its
# dq share into a (b, h, q tile) float32 sum once ``target`` = j -
# first_adder(qt) lower kv tiles have added, releasing its own add one step
# later (at the next visit's start, or at the tile's end).

BQ = 64


def _bkv(hd):
    return 128 if hd <= 128 else 64


def _q_range(k0, bkv, nqt, causal, window):
    begin = min(nqt, k0 // BQ) if causal else 0
    end = min(nqt, (k0 + bkv - 1 + window - 1) // BQ + 1) if window \
        else nqt
    return begin, max(begin, end)


def _first_adder(qt, bkv, window):
    if not window:
        return 0
    num = qt * BQ - bkv - window + 2
    return 0 if num <= 0 else -(-num // bkv)


def fused_schedule(B, H, KV, Sq, Skv, hd, causal, window):
    """The claim order's tiles as (t, j, b, kvh, k0, visits), a visit (h,
    qt, target)."""
    bkv, nqt, G = _bkv(hd), -(-Sq // BQ), H // KV
    tiles = []
    for t in range(-(-Skv // bkv) * B * KV):
        j, b, kvh = t // (B * KV), t % (B * KV) // KV, t % KV
        begin, end = _q_range(j * bkv, bkv, nqt, causal, window)
        visits = [(kvh * G + h, qt, j - _first_adder(qt, bkv, window))
                  for h in range(G) for qt in range(begin, end)]
        tiles.append((t, j, b, kvh, j * bkv, visits))
    return tiles


def run_schedule(tiles, n_ctas):
    """Steps ``n_ctas`` persistent CTAs through the schedule in lockstep
    rounds, each claiming the next tile when its last one ends and
    waiting at a visit until its counter reaches the target; returns each
    (b, h, q tile)'s adders in the order they added, raising on a round
    in which no CTA can move (a deadlock)."""
    counters, adds = {}, {}
    queue = list(tiles)
    ctas = [None] * n_ctas          # [tile, next visit, pending counter]
    while True:
        for c in range(n_ctas):
            if ctas[c] is None and queue:
                ctas[c] = [queue.pop(0), 0, None]
        if all(x is None for x in ctas):
            return adds
        moved = False
        for c, x in enumerate(ctas):
            if x is None:
                continue
            (t, j, b, kvh, k0, visits), s, pending = x
            if s == len(visits):    # the tile's end releases its last add
                if pending is not None:
                    counters[pending] = counters.get(pending, 0) + 1
                ctas[c] = None
                moved = True
                continue
            h, qt, target = visits[s]
            if pending is not None:  # the next visit's start releases it
                counters[pending] = counters.get(pending, 0) + 1
                x[2] = pending = None
                moved = True
            key = (b, h, qt)
            if counters.get(key, 0) < target:
                continue
            assert counters.get(key, 0) == target, (key, target)
            adds.setdefault(key, []).append(j)
            x[1], x[2] = s + 1, key
            moved = True
        if not moved:
            raise AssertionError("no CTA can move: the schedule deadlocks")


FUSED_CASES = [c for c in CASES if c[5] <= 256]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_schedule_visits_sums_and_claims(case):
    """Every kept (q, k) pair is visited exactly once; each (b, h, q tile)
    gets its kv tiles' adds in ascending order, its counter's target
    being the adds before it; no visit waits on a tile claimed after its
    own; and persistent CTAs (1, 3 and 8 of them) run the schedule to its
    end."""
    B, H, KV, Sq, Skv, hd, causal, window, _ = case
    hd = max(hd, 32)
    tiles = fused_schedule(B, H, KV, Sq, Skv, hd, causal, window)
    bkv = _bkv(hd)
    qi, kj = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kj <= qi
    if window:
        keep &= qi - kj < window
    seen = np.zeros((B, H, Sq, Skv), np.int64)
    claimed = {}
    for t, j, b, kvh, k0, visits in tiles:
        claimed[(b, kvh, j)] = t
        for h, qt, _ in visits:
            seen[b, h, qt * BQ:(qt + 1) * BQ, k0:k0 + bkv] += 1
    assert (seen[:, :, keep] == 1).all()
    adders = {}
    for t, j, b, kvh, k0, visits in tiles:
        for h, qt, target in visits:
            adders.setdefault((b, h, qt), []).append((j, target, t, kvh))
    for (b, h, qt), lst in adders.items():
        js = [j for j, _, _, _ in lst]
        assert js == sorted(js) and js == list(range(js[0], js[-1] + 1))
        for n, (j, target, t, kvh) in enumerate(lst):
            assert target == n
            assert all(claimed[(b, kvh, j2)] < t for j2 in js[:n])
    for n_ctas in (1, 3, 8):
        adds = run_schedule(tiles, n_ctas)
        assert adds == {key: [j for j, _, _, _ in lst]
                        for key, lst in adders.items()}


def emulate_fused_backward(q, k, v, out, lse, dout, *, causal, window,
                           softcap):
    """The fused kernel's arithmetic visit by visit, in the schedule's
    order: S^T and dP^T float32 products of a kv tile and a 64-row q tile,
    P^T = exp2(s' - lse'), dS^T = P^T (dP^T - D) f, P and dS rounded to
    bf16 before dV += P^T.dO, dK += dS^T.Q and dq's share dS.K, each
    share added to its (b, h, q tile) float32 sum in ascending kv-tile
    order (the first stores), dq = sum * scale, 0 where no tile added."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    log2e = 1.4426950408889634
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1)
    tiles = fused_schedule(B, H, KV, Sq, Skv, max(hd, 32), causal, window)
    bkv = _bkv(max(hd, 32))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    acc = {}
    adds = run_schedule(tiles, 3)
    shares = {}
    for t, j, b, kvh, k0, visits in tiles:
        ks, vs = kf[b, kvh, k0:k0 + bkv], vf[b, kvh, k0:k0 + bkv]
        kj = torch.arange(k0, k0 + ks.shape[0])[:, None]
        for h, qt, _ in visits:
            rows = slice(qt * BQ, (qt + 1) * BQ)
            qs, os_ = qf[b, h, rows], dof[b, h, rows]
            il = torch.arange(qt * BQ, qt * BQ + qs.shape[0])[None, :]
            sT = ks @ qs.T
            dpT = vs @ os_.T
            f = torch.ones_like(sT)
            if softcap > 0:
                th = torch.tanh(sT * scale / softcap)
                s2, f = th * softcap * log2e, 1 - th * th
            else:
                s2 = sT * (scale * log2e)
            kept = torch.ones_like(sT, dtype=torch.bool)
            if causal:
                kept &= kj <= il
            if window:
                kept &= il - kj < window
            pT = torch.where(kept, torch.exp2(
                s2 - lse[b, h, rows][None, :] * log2e), 0.0)
            dsT = pT * (dpT - delta[b, h, rows][None, :]) * f
            pT, dsT = pT.bfloat16().float(), dsT.bfloat16().float()
            dv[b, kvh, k0:k0 + bkv] += pT @ os_
            dk[b, kvh, k0:k0 + bkv] += dsT @ qs
            shares[(b, h, qt, j)] = dsT.T @ ks
    dq = torch.zeros_like(qf)
    for (b, h, qt), js in adds.items():
        for n, j in enumerate(js):
            share = shares[(b, h, qt, j)]
            acc[(b, h, qt)] = share if n == 0 else acc[(b, h, qt)] + share
        dq[b, h, qt * BQ:(qt + 1) * BQ] = acc[(b, h, qt)] * scale
    return dq.bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_kernel_model_matches_jax_vjp(case):
    """The fused kernel's schedule and roundings, modelled visit by visit
    (``emulate_fused_backward``), keep each gradient within the bf16
    limits of jax.vjp of the reference (2e-2 of max |grad|, 1e-2 relative
    RMS) at the same bfloat16 inputs."""
    causal, window, cap = case[6:]
    arrays = [np.asarray(torch.from_numpy(a).bfloat16().float())
              for a in _arrays(case, seed=case[5] + 2)]
    _, jgrads = _jax_vjp(*arrays, causal, window, cap)
    tq, tk_, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=causal, window=window, softcap=cap)
    out, lse = attention_lse_ref(tq, tk_, tv, **kw)
    grads = emulate_fused_backward(tq, tk_, tv, out, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        got = g.float().numpy()
        assert _share(got, w) <= BF16_TOL, (name, _share(got, w))
        assert _rel_rms(got, w) <= RMS_LIMIT, (name, _rel_rms(got, w))


def test_fused_schedule_model_catches_a_reversed_claim_order():
    """Negative control: claiming each chain's kv tiles from the highest
    down makes the first CTA wait on a tile no CTA has claimed, which
    ``run_schedule`` reports as a deadlock."""
    tiles = fused_schedule(1, 2, 1, 256, 256, 64, True, None)
    with pytest.raises(AssertionError, match="deadlocks"):
        run_schedule(tiles[::-1], 1)
    assert run_schedule(tiles, 1)
