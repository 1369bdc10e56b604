"""The decode-attention kernel (``kernels/flash_attention/flash_decode.py``,
``csrc/flash_decode.cu``) and the decode route of ``models/layers``.

On the CPU: the route sends CPU tensors to ``sdpa`` (or to the plain
``flash_decode`` twin under ``FLASH_DECODE_ENABLED``) and never to the
kernel's op; the launcher's host arithmetic (the attended key range, the
split plan, the head groups, which calls the kernel takes); the op's fake
implementation; and a model of the kernel's schedule — splits, each
split's slots of lanes walking every n-th key a few keys at a time, the
slots and then the splits combined in a fixed order, in the kernel's
roundings — against ``sdpa``.  On
the card (``cuda`` marker, skipped without one) the kernel itself against
``sdpa``, bit-equal over two calls, and a 24-layer internlm2 ``serve_batch``
decoding through it.  No JAX here, so the card's cases run on its machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_decode.py
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_decode as fd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

#: (elementwise, relative RMS) limits against sdpa: the elementwise one a
#: share of max |output| (an output of 8,200 keys is ~0.02 in size, so an
#: absolute limit would pass a dropped split); bf16 as the flash kernels'
#: 2e-2 and 1e-2, fp16 with its three more mantissa bits tighter, float32
#: within 1e-4 of the output's scale
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float16: (5e-3, 2.5e-3),
       torch.float32: (1e-4, 1e-4)}

# (B, Skv, H, KV, hd, vd, kv_len, window, softcap): internlm2's decode
# shape, groups of 1, 2, 5 and 8, head dims 64, 128, 256, MLA's 192 / 128,
# lengths off the slots' steps and the splits, a window, a softcap, one
# batch row
CASES = [
    (8, 8232, 16, 8, 128, 128, 8200, None, 0.0),
    (2, 1100, 8, 8, 64, 64, 1037, None, 0.0),
    (2, 3000, 16, 2, 128, 128, 2999, 1000, 0.0),
    (1, 2500, 16, 2, 256, 256, 2311, None, 30.0),
    (2, 700, 8, 1, 128, 128, 613, None, 0.0),
    (1, 900, 16, 16, 192, 128, 777, None, 0.0),
    (3, 100, 10, 2, 64, 64, 37, 20, 50.0),
]
DTYPES = [torch.bfloat16, torch.float32]


def _case_id(case):
    B, Skv, H, KV, hd, vd, kv_len, window, cap = case
    return (f"B{B}-S{Skv}-H{H}-KV{KV}-hd{hd}-vd{vd}-len{kv_len}"
            f"-w{window}-cap{cap:g}")


def _inputs(case, dtype, device, seed=0):
    B, Skv, H, KV, hd, vd, kv_len, window, cap = case
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g, device=device).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g, device=device).to(dtype)
    v = torch.randn((B, Skv, KV, vd), generator=g, device=device).to(dtype)
    kw = dict(kv_len=kv_len, window=window, attn_softcap=cap,
              q_offset=kv_len - 1, scale=None)
    return q, k, v, kw


def _close(got, want, dtype):
    """``got`` within ``TOL[dtype]`` of ``want``: every element within its
    share of max |want|, and the relative RMS error within its limit."""
    elem, rms = TOL[dtype]
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    assert err <= elem * float(want.abs().max()), (
        f"max abs err {err:.3e} above {elem} of max |want| "
        f"{float(want.abs().max()):.3e}")
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= rms, f"relative RMS error {rel:.3e} above {rms}"


# -- the route on the CPU -----------------------------------------------------


@pytest.mark.parametrize("enabled,Skv,want", [
    (False, 40, "sdpa"), (False, L.FLASH_DECODE_THRESHOLD, "sdpa"),
    (True, 40, "sdpa"), (True, L.FLASH_DECODE_THRESHOLD, "flash_decode")])
def test_route_keeps_cpu_tensors_off_the_kernel(monkeypatch, enabled, Skv,
                                                want):
    """A CPU decode call goes to sdpa, or to the twin with flash decode on
    and a long enough cache, and never reaches the kernel's op."""
    taken = []

    def never(*a, **k):
        raise AssertionError("the kernel's op on a CPU tensor")

    def spy(name, fn):
        def run(*a, **k):
            taken.append(name)
            return fn(*a, **k)
        return run

    monkeypatch.setattr(flash_ops, "flash_decode_op", never)
    monkeypatch.setattr(L, "FLASH_DECODE_ENABLED", enabled)
    monkeypatch.setattr(L, "sdpa", spy("sdpa", L.sdpa))
    monkeypatch.setattr(L, "flash_decode", spy("flash_decode",
                                               L.flash_decode))
    q, k, v, kw = _inputs((1, Skv, 4, 2, 16, 16, Skv - 3, None, 0.0),
                          torch.float32, "cpu")
    out = L.auto_sdpa(q, k, v, causal=True, **kw)
    assert taken == [want]
    assert out.shape == (1, 1, 4, 16)


def _stub(device, shape, dtype):
    return SimpleNamespace(device=torch.device(device), shape=shape,
                           dtype=dtype, dim=lambda: len(shape),
                           element_size=lambda: dtype.itemsize)


@pytest.mark.parametrize("device,Sq,dtype,hd,vd,want", [
    ("cuda", 1, torch.bfloat16, 128, 128, True),
    ("cuda", 1, torch.float16, 192, 128, True),
    ("cuda", 1, torch.float32, 16, 16, True),
    ("cuda", 1, torch.bfloat16, 256, 256, True),
    ("cpu", 1, torch.bfloat16, 128, 128, False),
    ("meta", 1, torch.bfloat16, 128, 128, True),
    ("cuda", 2, torch.bfloat16, 128, 128, False),
    ("cuda", 1, torch.float64, 128, 128, False),
    ("cuda", 1, torch.bfloat16, 320, 320, False),
    ("cuda", 1, torch.bfloat16, 12, 12, False),
])
def test_kernel_takes_by_shape_dtype_and_device(device, Sq, dtype, hd, vd,
                                                want):
    q = _stub(device, (2, Sq, 4, hd), dtype)
    k = _stub(device, (2, 50, 2, hd), dtype)
    v = _stub(device, (2, 50, 2, vd), dtype)
    assert fd.kernel_takes(q, k, v) is want


# -- the launcher's host arithmetic ------------------------------------------


@pytest.mark.parametrize("args,want", [
    ((8232, 8200, True, None, 8199), (0, 8200)),      # attention_block
    ((2048, 1500, False, None, 0), (0, 1500)),        # a ring, filling
    ((2048, 2048, False, None, 0), (0, 2048)),        # a ring, full
    ((5000, 4999, True, 1000, 4998), (3999, 4999)),   # a window
    ((100, None, True, None, 49), (0, 50)),           # causal, no kv_len
    ((100, None, False, None, 49), (0, 100)),
])
def test_key_range_is_what_sdpa_leaves_unmasked(args, want):
    assert fd.key_range(*args) == want
    Skv, kv_len, causal, window, q_offset = args
    q = torch.zeros((1, 1, 1, 1))
    k = torch.zeros((1, Skv, 1, 1))
    scores = torch.arange(Skv, dtype=torch.float32)
    v = scores.reshape(1, Skv, 1, 1)
    # zero keys: sdpa weighs the attended keys alike and the rest by 0, so
    # with v = position the output is the attended range's mean
    out = L.sdpa(q, k, v, causal=causal, window=window, kv_len=kv_len,
                 q_offset=q_offset)
    lo, hi = want
    assert float(out) == pytest.approx((lo + hi - 1) / 2)


@pytest.mark.parametrize("n,ctas,want", [
    (8200, 64, (17, 512)),        # internlm2's decode
    (224, 96, (1, 224)),          # whisper's decoder: one split
    (2048, 8, (8, 256)),          # a 2k ring, MQA of 16
    (300, 64, (2, 256)),
    (37, 2, (1, 37)),
    (100_000, 4096, (1, 100_000)),
])
def test_split_plan_covers_the_card(n, ctas, want):
    splits, chunk = fd.split_plan(n, ctas, 132)
    assert (splits, chunk) == want
    assert (splits - 1) * chunk < n <= splits * chunk
    assert splits == 1 or (chunk >= fd.MIN_SPLIT_KEYS
                           and chunk % fd.SPLIT_ALIGN == 0)


@pytest.mark.parametrize("G,want", [(1, 1), (2, 2), (5, 8), (8, 8),
                                    (16, 8), (64, 8)])
def test_head_group(G, want):
    assert fd.head_group(G) == want


def test_fake_gives_the_output_shape():
    q = torch.empty((2, 1, 16, 192), device="meta", dtype=torch.bfloat16)
    k = torch.empty((2, 300, 16, 192), device="meta", dtype=torch.bfloat16)
    v = torch.empty((2, 300, 16, 128), device="meta", dtype=torch.bfloat16)
    out = flash_ops.flash_decode_op(q, k, v, 200, None, 0.0, 199, None, True)
    assert out.shape == (2, 1, 16, 128) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("dropped", [1, 8])
def test_limits_catch_a_dropped_key(dtype, dropped):
    """At internlm2's decode length the limits of ``TOL`` refuse sdpa with
    its last keys left out (the relative RMS error catches even one),
    where an absolute 2e-2, larger than a typical output, passes it."""
    q, k, v, kw = _inputs((2, 8208, 16, 8, 128, 128, 8200, None, 0.0),
                          dtype, "cpu", seed=34)
    want = L.sdpa(q, k, v, causal=True, **kw)
    short = L.sdpa(q, k, v, causal=True, **dict(kw, kv_len=8200 - dropped))
    with pytest.raises(AssertionError):
        _close(short, want, dtype)
    torch.testing.assert_close(short.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_meta_tensors_count_the_kernel_route():
    """The dry run's meta tensors take the kernel's op, as the card does:
    the counting mode charges one call of ``flash_decode`` its formula in
    ``kernels/cost.py``, whose FLOPs are what sdpa's two products over the
    same keys count."""
    from repro_torch.kernels.cost import flash_decode_cost
    from repro_torch.launch import op_analysis
    B, Skv, H, KV, hd, vd, kv_len = 2, 300, 16, 2, 192, 128, 257
    q = torch.empty((B, 1, H, hd), device="meta", dtype=torch.bfloat16)
    k = torch.empty((B, Skv, KV, hd), device="meta", dtype=torch.bfloat16)
    v = torch.empty((B, Skv, KV, vd), device="meta", dtype=torch.bfloat16)
    kw = dict(causal=True, kv_len=kv_len, q_offset=kv_len - 1)
    out, got = op_analysis.count(L.auto_sdpa, q, k, v, **kw)
    assert out.shape == (B, 1, H, vd) and out.device.type == "meta"
    assert got.kernel_calls == {"flash_decode": 1}
    assert (got.flops, got.hbm_bytes) == flash_decode_cost(
        B, H, KV, kv_len, hd, vd, 2)
    _, plain = op_analysis.count(L.sdpa, q, k, v, **kw)
    assert plain.kernel_calls == {} and plain.flops == got.flops


# -- a model of the kernel's schedule against sdpa ---------------------------


def _combine(parts):
    """(m, l, acc) of several runs of keys merged in their order, as the
    kernel merges its slots and then its splits."""
    mx = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - mx) for p in parts]
    return (mx, sum(p[1] * wi for p, wi in zip(parts, w)),
            sum(p[2] * wi[..., None] for p, wi in zip(parts, w)))


def kernel_model(q, k, v, *, kv_len, window, attn_softcap, q_offset, scale,
                 causal=True, sms=132):
    """The kernel's arithmetic, step by step: the launcher's key range and
    splits; in a split, ``4 × 32 / lpk`` slots, slot ``s`` walking keys
    ``s, s + slots, …`` a few at a time (its running (m, l, acc) updated
    once a step); q scaled in its type, float32 scores, p rounded to v's
    type for P·V; the slots combined in order, then the splits."""
    B, _, H, hd = q.shape
    Skv, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    lo, hi = fd.key_range(Skv, kv_len, causal, window, q_offset)
    gc = fd.head_group(G)
    splits, chunk = fd.split_plan(hi - lo, B * KV * -(-G // gc), sms)
    vec = 16 // q.element_size()
    width = max(hd, vd) // vec
    cpl = 2 if width > 32 else 1
    lpk = 1
    while lpk * cpl < width:
        lpk *= 2
    slots, step = 4 * 32 // lpk, 2 if gc >= 8 else 8
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qs = (q * scale).float().reshape(B, KV, G, hd)
    parts = []
    for s in range(splits):
        b0 = lo + s * chunk
        b1 = min(hi, b0 + chunk)
        runs = []
        for slot in range(slots):
            m = torch.full((B, KV, G), -1e30)
            l = torch.zeros((B, KV, G))
            acc = torch.zeros((B, KV, G, vd))
            keys = list(range(b0 + slot, b1, slots))
            for i in range(0, len(keys), step):
                idx = torch.tensor(keys[i:i + step])
                sc = torch.einsum("bkgd,bnkd->bkgn", qs,
                                  k[:, idx].float())
                if attn_softcap > 0:
                    sc = torch.tanh(sc / attn_softcap) * attn_softcap
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgn,bnkd->bkgd", p.to(v.dtype).float(),
                    v[:, idx].float())
                m = m_new
            runs.append((m, l, acc))
        parts.append(_combine(runs))
    _, l, acc = _combine(parts)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, vd).to(q.dtype), splits


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES[1:], ids=_case_id)
def test_kernel_schedule_matches_sdpa(case, dtype):
    """The kernel's schedule, modelled in torch on the CPU, against sdpa:
    the split plan covers the attended keys and nothing else, and the
    merge is exact up to float32 rounding (several splits at these
    lengths: the card's 132 SMs against a handful of CTAs)."""
    q, k, v, kw = _inputs(case, dtype, "cpu")
    got, splits = kernel_model(q, k, v, **kw)
    want = L.sdpa(q, k, v, causal=True, **kw)
    _close(got, want, dtype)
    twin = L.flash_decode(q, k, v, **kw)
    _close(got, twin, dtype)


def test_kernel_schedule_splits_at_the_tested_lengths():
    """The schedule test above exercises the merge: most of its cases split
    the keys."""
    split = [kernel_model(*_inputs(c, torch.float32, "cpu")[:3],
                          **_inputs(c, torch.float32, "cpu")[3])[1]
             for c in CASES[1:]]
    assert sum(s > 1 for s in split) >= len(split) - 1


# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES + [torch.float16], ids=str)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_flash_decode_kernel_matches_sdpa(cuda, case, dtype):
    """The kernel, through ``auto_sdpa``'s route, against sdpa on the card
    within ``TOL``, against the plain twin alike, bit-equal over two calls,
    one count a call."""
    q, k, v, kw = _inputs(case, dtype, cuda)
    fd.reset_launches()
    got = L.auto_sdpa(q, k, v, causal=True, **kw)
    again = L.auto_sdpa(q, k, v, causal=True, **kw)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == 2
    assert torch.equal(got, again)
    _close(got, L.sdpa(q, k, v, causal=True, **kw), dtype)
    _close(got, L.flash_decode(q, k, v, **kw), dtype)


@pytest.mark.cuda
def test_cuda_flash_decode_reads_the_cache_in_place(cuda):
    """A cache of (B, L, KV, hd) read through a strided view (k and v
    halves of one buffer) gives what contiguous copies give, bit for bit."""
    q, k, v, kw = _inputs(CASES[2], torch.bfloat16, cuda)
    kv = torch.cat([k, v], dim=-1)
    got = L.auto_sdpa(q, kv[..., :128], kv[..., 128:], causal=True, **kw)
    want = L.auto_sdpa(q, k, v, causal=True, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_serve_batch_decodes_through_the_kernel(cuda, monkeypatch):
    """internlm2 at its 24 layers and head dim 128, narrow elsewhere, in
    float32: ``serve_batch`` runs the decode kernel once a layer and
    decode step, and generates the ids the sdpa route generates."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), d_model=256,
                              d_ff=512, vocab_size=1024,
                              param_dtype="float32")
    params = TT.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70),
                                                dtype=np.int32)
    gen = 16
    fd.reset_launches()
    got, _ = tserve.serve_batch(cfg, params, prompts, gen, device=cuda)
    assert fd.LAUNCHES["flash_decode"] == cfg.num_layers * gen == 24 * 16
    monkeypatch.setattr(fd, "kernel_takes", lambda q, k, v: False)
    fd.reset_launches()
    want, _ = tserve.serve_batch(cfg, params, prompts, gen, device=cuda)
    assert fd.LAUNCHES["flash_decode"] == 0
    np.testing.assert_array_equal(got, want)
