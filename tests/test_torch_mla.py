"""The torch port's Multi-head Latent Attention (``models/mla.py``) against
the JAX package.

Seeded weights from the reference's ``mla_init`` and seeded numpy inputs
go to both packages, in float32, within 1e-4.  The port's full-sequence
attention takes the padded route of the flash-attention kernel (q and k
zero-padded from nope + rope to a kernel head dim, v to the same, the
scale passed explicitly, the output sliced back); on CPU tensors that is
the kernel's plain version over the padded tensors, whose arithmetic is
held here against the reference's unpadded ``sdpa``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro_torch import tree as TR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402

TOL = 1e-4
# (H, kv_lora, q_lora, nope, rope, v): reduced deepseek-v2, and deepseek-v2's
# own per-head dims (nope 128 + rope 64 = 192 → padded to 256) at few heads
DIMS = [(4, 32, 48, 16, 8, 16), (2, 64, 48, 128, 64, 128)]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _setup(dims, B=2, S=12, D=64, seed=0):
    H, R, Q, nd, rd, vd = dims
    jp = JMLA.mla_init(jax.random.PRNGKey(seed), D, H, kv_lora_rank=R,
                       q_lora_rank=Q, nope_head_dim=nd, rope_head_dim=rd,
                       v_head_dim=vd, dtype=jnp.float32)
    tp = TR.map(convert.to_torch, jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, D)).astype(np.float32)
    kw = dict(num_heads=H, kv_lora_rank=R, nope_head_dim=nd,
              rope_head_dim=rd, v_head_dim=vd, rope_theta=1e4)
    return jp, tp, x, kw


@pytest.mark.parametrize("dims", DIMS)
def test_full_sequence_matches_reference(dims):
    jp, tp, x, kw = _setup(dims)
    pos = np.arange(x.shape[1])[None, :]
    want, _ = JMLA.mla_attention(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                 **kw)
    got, cache = TMLA.mla_attention(tp, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos), **kw)
    assert cache is None
    _close(got.numpy(), want, "mla full sequence")


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("dims", DIMS)
def test_prefill_and_decode_match_reference(dims, absorbed):
    """A prefill into a cache longer than the prompt, then three decode
    steps, the absorbed or the plain form; outputs and the latent caches."""
    jp, tp, x, kw = _setup(dims, S=9)
    H, R, _, _, rd, _ = dims
    B, S, D = x.shape
    L = S + 3
    jcache = {k: jnp.zeros(s, jnp.float32) for k, s in
              TMLA.mla_cache_shape(B, L, R, rd).items()}
    tcache = {k: torch.zeros(s) for k, s in
              TMLA.mla_cache_shape(B, L, R, rd).items()}
    pos = np.arange(S)[None, :]
    want, jcache = JMLA.mla_attention(jp, jnp.asarray(x),
                                      positions=jnp.asarray(pos),
                                      cache=jcache, cache_pos=0, **kw)
    got, tcache = TMLA.mla_attention(tp, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos),
                                     cache=tcache, cache_pos=0, **kw)
    _close(got.numpy(), want, "mla prefill")
    feed = np.random.default_rng(5).standard_normal((3, B, 1, D)).astype(
        np.float32)
    jfn = JMLA.mla_attention_absorbed if absorbed else JMLA.mla_attention
    tfn = TMLA.mla_attention_absorbed if absorbed else TMLA.mla_attention
    for i in range(3):
        p = np.array([[S + i]])
        want, jcache = jfn(jp, jnp.asarray(feed[i]), positions=jnp.asarray(p),
                           cache=jcache, cache_pos=S + i, **kw)
        got, tcache = tfn(tp, torch.from_numpy(feed[i]),
                          positions=torch.from_numpy(p), cache=tcache,
                          cache_pos=S + i, **kw)
        _close(got.numpy(), want, f"mla decode step {i}")
        for k in ("ckv", "krope"):
            _close(tcache[k].numpy(), jcache[k], f"cache {k} step {i}")


@pytest.mark.parametrize("dims", DIMS)
def test_absorbed_decode_equals_the_plain_form(dims):
    """The port's two decode forms over one cache: the same attention."""
    _, tp, x, kw = _setup(dims, S=11, seed=3)
    H, R, _, _, rd, _ = dims
    B, S, _ = x.shape
    shapes = TMLA.mla_cache_shape(B, S + 1, R, rd)
    caches = [{k: torch.zeros(s) for k, s in shapes.items()} for _ in (0, 1)]
    xt = torch.from_numpy(x)
    prompt, last = xt[:, :-1], xt[:, -1:]
    outs = []
    for cache, fn in zip(caches, (TMLA.mla_attention,
                                  TMLA.mla_attention_absorbed)):
        TMLA.mla_attention(tp, prompt, positions=torch.arange(S - 1)[None],
                           cache=cache, cache_pos=0, **kw)
        y, _ = fn(tp, last, positions=torch.tensor([[S - 1]]), cache=cache,
                  cache_pos=S - 1, **kw)
        outs.append(y)
    _close(outs[1].numpy(), outs[0].numpy(), "absorbed vs plain")


@pytest.mark.parametrize("qk,v,hd", [(192, 128, 256), (24, 16, 32),
                                     (64, 64, 64), (100, 128, 128)])
def test_padded_head_dim(qk, v, hd):
    assert TMLA.padded_head_dim(qk, v) == hd


def test_padded_head_dim_refuses_what_the_kernel_cannot_take():
    """The flash kernels take any head dim above 256 that is a multiple of
    32 (slices of built widths), so no MLA width is refused any more:
    above 256 the padded head dim is the next multiple of 32."""
    assert TMLA.padded_head_dim(320, 128) == 320
    assert TMLA.padded_head_dim(300, 128) == 320
    assert TMLA.padded_head_dim(192, 288) == 288


@pytest.mark.parametrize("dims", DIMS)
def test_padded_route_is_exact_on_the_plain_kernel(dims, monkeypatch):
    """The padded route hands the kernel (its plain twin here) q, k and v of
    one padded head dim, zeros past nope + rope and past v, and the scale
    1/sqrt(nope + rope); the result equals the reference's unpadded causal
    sdpa within float32 rounding."""
    H, _, _, nd, rd, vd = dims
    B, S = 2, 10
    rng = np.random.default_rng(7)
    qn, qr = (rng.standard_normal((B, S, H, d)).astype(np.float32)
              for d in (nd, rd))
    kn = rng.standard_normal((B, S, H, nd)).astype(np.float32)
    kr = rng.standard_normal((B, S, rd)).astype(np.float32)
    v = rng.standard_normal((B, S, H, vd)).astype(np.float32)
    scale = 1.0 / math.sqrt(nd + rd)
    seen = []
    real = flash_ops.attention

    def spy(q, k, vv, **kw):
        seen.append((q, k, vv, kw))
        return real(q, k, vv, **kw)
    monkeypatch.setattr(flash_ops, "attention", spy)
    got = TMLA.padded_attention(*(torch.from_numpy(a)
                                  for a in (qn, qr, kn, kr, v)), scale)
    (q, k, vv, kw), = seen
    hd = TMLA.padded_head_dim(nd + rd, vd)
    assert q.shape[-1] == k.shape[-1] == vv.shape[-1] == hd
    assert kw["scale"] == scale and kw["causal"]
    assert not q[..., nd + rd:].any() and not k[..., nd + rd:].any()
    assert not vv[..., vd:].any()
    jq = jnp.concatenate([qn, qr], -1)
    jk = jnp.concatenate([kn, np.broadcast_to(kr[:, :, None],
                                              (B, S, H, rd))], -1)
    want = JL.sdpa(jq, jk, jnp.asarray(v), causal=True, scale=scale)
    assert tuple(got.shape) == (B, S, H, vd)
    _close(got.numpy(), want, "padded route")
