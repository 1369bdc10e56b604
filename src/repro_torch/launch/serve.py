"""Batched LM serving driver: prefill a batch of prompts, decode N tokens.

The port of the JAX package's ``launch/serve.py``.  Prefill runs the
full-sequence mixers through the hand-written kernels (flash attention for
attention layers, an encoder's layers and cross-attention, the chunked SSD
scan for SSD layers); decode runs the cached attention and the SSD and
RG-LRU recurrences in torch.  An encoder config (whisper) takes
``frames``; the CLI gives it zeros, as the reference's does.  It runs on the card
unless the caller asks for the CPU (``device="cpu"``); with no card and no
such request it raises.

    python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 8 --prompt-len 4096 --gen 32
    python -m repro_torch.launch.serve --arch internlm2-1.8b --reduced \
        --device cpu

Parameters may be DTensors on a ``DeviceMesh`` (laid out by
``launch/shardings.py``): the prompts are then placed on the mesh by the
batch rules and the step runs in SPMD mode (``pjit_utils``), each rank on
its shards.

Greedy decoding takes the first maximal logit, the reference's rule.
Sampling draws from an explicit ``torch.Generator`` seeded with ``seed``;
its bits differ from ``jax.random``'s, so sampled tokens are not the
reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree
from ..configs import get_config
from ..configs.reduced import reduced as make_reduced
from ..models import transformer as T
from ..obs.tracer import span as _span
from ..pjit_utils import mesh_of


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CPU run must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device='cpu' to serve on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree if mesh_of(tree) is not None else tree.to(device)


@contextlib.contextmanager
def _spmd(mesh):
    """SPMD mode, with plain tensors (positions, masks) read as replicated,
    while a step runs on a mesh; nothing without one."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from ..pjit_utils import enable_spmd, spmd_enabled
    was = spmd_enabled()
    enable_spmd(True)
    try:
        with implicit_replication():
            yield
    finally:
        enable_spmd(was)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, params, prompts: np.ndarray, gen_tokens: int,
                frames=None, greedy: bool = True, seed: int = 0, device=None
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """prompts: (B, S) int32 → (B, gen_tokens) generated ids + stats;
    ``frames`` (B, F, D), an encoder config's frame embeddings.

    ``params`` and ``frames`` are moved to ``device`` (a no-op where they
    already are).  Times are host clocks around work that ends in a
    synchronize.  With tracing on, the call records ``lm.serve_batch`` ⊃
    ``lm.prefill`` (the interval ``prefill_s`` times) and ``lm.decode``
    (the interval ``decode_s`` times) ⊃ one ``lm.decode_step`` a token."""
    B, S = prompts.shape
    with _span("lm.serve_batch", "lm", batch=B, prompt_len=S,
               gen_tokens=gen_tokens):
        device = resolve_device(device)
        params = _to(params, device)
        if frames is not None:
            frames = torch.as_tensor(frames).to(device)
        cache_len = S + gen_tokens
        tokens = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
        mesh = mesh_of(tree.leaves(params)[0])
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor

            from ..core.sharding_bridge import P
            from .shardings import batch_axes_for, to_placements
            dp = batch_axes_for(B, cfg, mesh)
            tokens = distribute_tensor(tokens, mesh, to_placements(
                mesh, P(dp if len(dp) != 1 else dp[0], None) if dp
                else P(None, None)))
        gen = torch.Generator(device=device).manual_seed(seed)

        def pick(logits: torch.Tensor) -> torch.Tensor:
            if greedy:
                return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            probs = torch.softmax(logits.float(), dim=-1)
            return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

        # DTensor views cannot be taken in inference mode: no_grad on a mesh
        grad_off = torch.inference_mode() if mesh is None else torch.no_grad()
        with grad_off, _spmd(mesh):
            _sync(device)
            with _span("lm.prefill", "lm"):
                t0 = time.perf_counter()
                logits, cache = T.prefill(cfg, params, tokens, frames=frames,
                                          cache_len=cache_len)
                tok = pick(logits)
                _sync(device)
                prefill_s = time.perf_counter() - t0

            out: List[torch.Tensor] = []
            with _span("lm.decode", "lm"):
                t0 = time.perf_counter()
                for i in range(gen_tokens):
                    out.append(tok[:, 0])
                    with _span("lm.decode_step", "lm"):
                        logits, cache = T.decode_step(cfg, params, cache, tok,
                                                      S + i)
                        tok = pick(logits)
                generated = torch.stack(out, dim=1)
                if mesh is not None:
                    generated = generated.full_tensor()
                generated = generated.cpu().numpy()              # synchronizes
                _sync(device)
                decode_s = time.perf_counter() - t0
        return generated, {
            "prefill_s": prefill_s, "decode_s": decode_s,
            "tokens_per_s": B * gen_tokens / max(decode_s, 1e-9),
            "device": str(device)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    frames = None
    if cfg.encoder is not None:
        frames = torch.zeros((args.batch, cfg.encoder.num_frames, cfg.d_model),
                             dtype=T.dtype_of(cfg), device=device)
    out, stats = serve_batch(cfg, params, prompts, args.gen, frames=frames,
                             seed=args.seed, device=device)
    print(f"[serve] {cfg.name} on {stats['device']}: generated {out.shape} "
          f"prefill={stats['prefill_s']:.2f}s decode={stats['decode_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
