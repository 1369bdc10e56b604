"""Batched serving on the PyTorch/CUDA port, the counterpart of
``examples/serve_batch.py``: prefill a prompt batch, decode tokens with a
KV cache.

Uses the internlm2-1.8b family at reduced width with seeded random
weights; the same ``repro_torch.launch.serve`` entry point serves the
full config (``python -m repro_torch.launch.serve --arch
internlm2-1.8b``).  The reduced config's head dim is 16, the JAX
example's; on the card the flash kernel runs it zero-padded to 32.

Run:  PYTHONPATH=src python examples/torch/serve_batch.py              # card
      PYTHONPATH=src python examples/torch/serve_batch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced
from repro_torch.launch.serve import resolve_device, serve_batch
from repro_torch.models import transformer as T


def config():
    """internlm2-1.8b at reduced width, the JAX example's config."""
    return reduced(get_config("internlm2-1.8b"))


def generate(cfg, params, prompts, device, gen_tokens=32):
    """``gen_tokens`` greedy tokens for each prompt row."""
    gen, stats = serve_batch(cfg, params, prompts, gen_tokens=gen_tokens,
                             device=device)
    print(f"generated {gen.shape[1]} tokens for {gen.shape[0]} requests on "
          f"{stats['device']}: prefill {stats['prefill_s']:.2f}s, "
          f"{stats['tokens_per_s']:.1f} tok/s decode")
    assert np.isfinite(gen).all() and gen.shape == (len(prompts), gen_tokens)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises
    cfg = config()
    params = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (4, 64), dtype=np.int32)
    return generate(cfg, params, prompts, device)


if __name__ == "__main__":
    main()
