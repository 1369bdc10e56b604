"""Train an LM end to end on the PyTorch/CUDA port, with a mid-run
injected node failure and automatic checkpoint restart (exactly-once data
replay): the counterpart of ``examples/train_lm.py``.

The arch is the mamba2-370m family at reduced width (~2M params, seeded
random weights; pass --full-370m to train the real config — same code
path, the SSD kernel on the card).

Run:  PYTHONPATH=src python examples/torch/train_lm.py                 # card
      PYTHONPATH=src python examples/torch/train_lm.py --device cpu
"""

import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import TrainRun, train_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-370m", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises

    cfg = get_config("mamba2-370m")
    if not args.full_370m:
        cfg = reduced(cfg)
        cfg = dataclasses.replace(cfg, num_layers=4)
    # the JAX example's 25 at its 120 steps; a shorter run still
    # checkpoints before the failure injected half way
    ckpt_every = min(25, max(1, args.steps // 4))
    with tempfile.TemporaryDirectory(prefix="lachesis_torch_ckpt_") as ckpt:
        run = TrainRun(cfg=cfg, total_steps=args.steps, global_batch=8,
                       seq_len=256, ckpt_dir=ckpt, ckpt_every=ckpt_every,
                       peak_lr=1e-3, fail_at_step=args.steps // 2,
                       device=str(device))
        out = train_with_restarts(run)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"\nloss {first:.3f} → {last:.3f} across an injected failure at "
          f"step {args.steps // 2} (restarted from step {out['start_step']} "
          f"on {device})")
    assert last < first, "training must make progress through the restart"
    return out


if __name__ == "__main__":
    main()
