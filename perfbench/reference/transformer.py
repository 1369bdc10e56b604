"""Plain float32 reference of a dense decoder-only transformer with grouped
query attention and a SwiGLU FFN (InternLM2, arXiv:2403.17297), in the
port's parameter layout.

Per layer: x += Wo · attn(RoPE(Wq h), RoPE(Wk h), Wv h) with h = norm(x),
causal, kv heads shared by groups of query heads; x += W_out (silu(W_gate
h) ⊙ W_in h) with h = norm(x).  Then a final norm and the logits h ·
unembedᵀ over the real vocabulary.  Each layer is recomputed in the
backward pass, attention in blocks of queries and the loss in blocks of
tokens, so the reference fits beside nothing but its own float32 state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from ..yardstick.cost import attention_pairs
from . import common as C


def _sizes(spec: Dict) -> Dict:
    c = spec["config"]
    D, H = c["hidden_size"], c["num_attention_heads"]
    hd = c.get("head_dim") or D // H
    vocab = c["vocab_size"]
    pad = spec["layout"]["vocab_pad_multiple"]
    return {"D": D, "H": H, "KV": c["num_key_value_heads"], "hd": hd,
            "F": c["intermediate_size"], "layers": c["num_hidden_layers"],
            "V": vocab, "Vp": -(-vocab // pad) * pad,
            "theta": float(c["rope_theta"]),
            "tied": bool(c["tie_word_embeddings"]),
            "dtype": C.DTYPES[c["torch_dtype"]]}


def program_fields(spec: Dict) -> Dict:
    """The port's ``ArchConfig`` values this configuration runs with."""
    s = _sizes(spec)
    return {"d_model": s["D"], "num_heads": s["H"], "num_kv_heads": s["KV"],
            "head_dim": s["hd"], "d_ff": s["F"], "num_layers": s["layers"],
            "vocab_size": s["V"], "padded_vocab": s["Vp"],
            "rope_theta": s["theta"], "tie_embeddings": s["tied"],
            "param_dtype": spec["config"]["torch_dtype"], "norm": "rmsnorm",
            "positional": "rope", "ffn_activation": "silu",
            "ffn_gated": True, "qkv_bias": False, "qk_norm": False,
            "logit_softcap": 0.0, "attn_softcap": 0.0, "embed_scale": False,
            "use_post_norm": False, "attn_scale": None,
            "mixers": ["attn"] * s["layers"], "ffns": ["dense"] * s["layers"]}


def leaves(spec: Dict) -> List[C.Leaf]:
    s = _sizes(spec)
    D, H, KV, hd, F, dt = s["D"], s["H"], s["KV"], s["hd"], s["F"], s["dtype"]
    out: List[C.Leaf] = [(("embed", "table"), (s["Vp"], D), dt, "normal",
                          0.02),
                         (("final_norm", "scale"), (D,), dt, "zeros", 0.0)]
    if not s["tied"]:
        out.append((("unembed", "table"), (s["Vp"], D), dt, "normal", 0.02))
    for i in range(s["layers"]):
        L = ("layers", i)
        out += [
            (L + ("ln_attn", "scale"), (D,), dt, "zeros", 0.0),
            (L + ("attn", "wq", "w"), (D, H * hd), dt, "normal",
             1 / math.sqrt(D)),
            (L + ("attn", "wk", "w"), (D, KV * hd), dt, "normal",
             1 / math.sqrt(D)),
            (L + ("attn", "wv", "w"), (D, KV * hd), dt, "normal",
             1 / math.sqrt(D)),
            (L + ("attn", "wo", "w"), (H * hd, D), dt, "normal",
             1 / math.sqrt(H * hd)),
            (L + ("ln_ffn", "scale"), (D,), dt, "zeros", 0.0),
            (L + ("ffn", "w_in", "w"), (D, F), dt, "normal", 1 / math.sqrt(D)),
            (L + ("ffn", "w_gate", "w"), (D, F), dt, "normal",
             1 / math.sqrt(D)),
            (L + ("ffn", "w_out", "w"), (F, D), dt, "normal",
             1 / math.sqrt(F)),
        ]
    return out


def init_params(spec: Dict, seed: int, device) -> Dict:
    return C.init_leaves(leaves(spec), seed, device)


def _layer(x, p, positions, s, precision):
    B, S, D = x.shape
    mm = lambda a, w: C.gemm(a, w, precision)             # noqa: E731
    h = C.rmsnorm(x, p["ln_attn"]["scale"])
    a = p["attn"]
    q = mm(h, a["wq"]["w"]).reshape(B, S, s["H"], s["hd"])
    k = mm(h, a["wk"]["w"]).reshape(B, S, s["KV"], s["hd"])
    v = mm(h, a["wv"]["w"]).reshape(B, S, s["KV"], s["hd"])
    q, k = C.rope(q, positions, s["theta"]), C.rope(k, positions, s["theta"])
    o = C.causal_attention(q, k, v).reshape(B, S, s["H"] * s["hd"])
    x = x + mm(o, a["wo"]["w"])
    h = C.rmsnorm(x, p["ln_ffn"]["scale"])
    f = p["ffn"]
    g = C.silu(mm(h, f["w_gate"]["w"])) * mm(h, f["w_in"]["w"])
    return x + mm(g, f["w_out"]["w"])


def _hidden(spec, params, tokens, precision):
    """Final-norm hidden states (B, S, D), float32."""
    s = _sizes(spec)
    x = params["embed"]["table"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p in params["layers"]:
        x = C.maybe_checkpoint(lambda x_, p_: _layer(x_, p_, positions, s,
                                                      precision), x, p)
    return C.rmsnorm(x, params["final_norm"]["scale"])


def _head(spec, params):
    return params["embed" if _sizes(spec)["tied"] else "unembed"]["table"]


def loss(spec: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Mean next-token cross-entropy of float32 ``params``."""
    h = _hidden(spec, params, tokens, precision)
    return C.mean_cross_entropy(h.reshape(-1, h.shape[-1]),
                                _head(spec, params), labels.reshape(-1),
                                _sizes(spec)["V"], precision)


@torch.no_grad()
def logits_at(spec: Dict, params: Dict, tokens: torch.Tensor,
              positions: Sequence[int], precision: str = "fp32"
              ) -> torch.Tensor:
    """Logits (B, len(positions), V) over the real vocabulary at the given
    positions of ``tokens`` (B, S), float32."""
    h = _hidden(spec, params, tokens, precision)[:, list(positions)]
    return C.gemm(h, _head(spec, params)[:_sizes(spec)["V"]].t(), precision)


def forward_flops(spec: Dict, batch: int, seq: int,
                  head_positions: int) -> float:
    """Model FLOPs of one forward pass over ``batch`` rows of ``seq``
    tokens, with the LM head applied at ``head_positions`` positions a
    row: 2 a multiply-add of every projection, FFN and head weight, and
    4·hd a kept (query, key) pair of every head (QKᵀ and PV)."""
    s = _sizes(spec)
    D, H, KV, hd, F = s["D"], s["H"], s["KV"], s["hd"], s["F"]
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    attn = 4.0 * hd * H * attention_pairs(seq, seq, True, None)
    return batch * (s["layers"] * (2.0 * per_layer * seq + attn)
                    + 2.0 * D * s["V"] * head_positions)


def train_flops(spec: Dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: three times the forward with the
    head at every position (no credit for recomputation)."""
    return 3.0 * forward_flops(spec, batch, seq, seq)
