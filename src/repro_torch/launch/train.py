"""End-to-end training driver: data pipeline → train loop → checkpoints,
with fault-tolerant restart and straggler-tolerant input; the port of the
JAX package's ``launch/train.py``.

It runs on the card unless the caller asks for the CPU (``device="cpu"``,
``--device cpu``); with no card and no such request it raises.

    python -m repro_torch.launch.train --arch mamba2-370m --reduced \
        --steps 20 --batch 8 --seq 64 --device cpu
    python -m repro_torch.launch.train --arch mamba2-370m --steps 100 \
        --batch 8 --seq 2048 --ckpt-dir build/ckpt

Checkpoints hold the train state in the reference's stacked layout
(``models/convert.py`` :func:`stack_state`), so a run of either package
resumes from the other's.  The initial weights come from a
``torch.Generator`` seeded with ``seed`` and differ from the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                     save_checkpoint)
from ..configs import get_config
from ..configs.reduced import reduced as make_reduced
from ..data.pipeline import DataConfig, TokenSource
from ..models.convert import stack_state, unstack_state
from ..models.transformer import dtype_of
from ..runtime.fault_tolerance import Coordinator, WorkerFailure
from ..runtime.straggler import StragglerMitigator
from . import steps as steps_lib
from .serve import resolve_device


@dataclasses.dataclass
class TrainRun:
    cfg: Any
    total_steps: int
    global_batch: int
    seq_len: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    peak_lr: float = 3e-4
    seed: int = 0
    log_every: int = 10
    fail_at_step: Optional[int] = None     # fault-injection for tests
    device: Optional[str] = None           # None → the card


def train(run: TrainRun) -> Dict[str, Any]:
    """Returns ``{"state", "losses", "step_s", "final_step", "start_step",
    "taken"}``: ``step_s`` holds each step's seconds (fetching its batch
    to reading its loss); ``taken`` lists ``(step, sum of the batch's
    tokens)`` for each step this call ran, in order (exactly-once after a
    restore shows there)."""
    cfg = run.cfg
    device = resolve_device(run.device)
    opt = steps_lib.make_optimizer(cfg, peak_lr=run.peak_lr,
                                   total_steps=run.total_steps)
    # the reference jits the step with donate_argnums=(0,)
    train_step = steps_lib.make_train_step(cfg, opt, donate=True)
    source = TokenSource(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=run.seq_len,
                                    global_batch=run.global_batch,
                                    num_hosts=1, seed=run.seed))
    coord = Coordinator(num_workers=1)
    straggler = StragglerMitigator()

    # init or restore
    gen = torch.Generator(device=device).manual_seed(run.seed)
    state = steps_lib.init_train_state(cfg, gen, opt, device=device)
    start = 0
    if run.ckpt_dir and latest_step(run.ckpt_dir) is not None:
        stacked, start, _extra = restore_checkpoint(run.ckpt_dir,
                                                    stack_state(cfg, state))
        state = unstack_state(cfg, stacked)
        print(f"[train] restored step {start}")

    losses: List[float] = []
    step_s: List[float] = []
    taken: List[tuple] = []
    t0 = time.time()
    step = start
    while step < run.total_steps:
        if run.fail_at_step is not None and step == run.fail_at_step:
            run.fail_at_step = None            # fail once
            raise WorkerFailure(f"injected failure at step {step}")
        ts = time.perf_counter()
        batch_np = straggler.fetch_shard(
            lambda s, h: source.batch_at(s, h), step, host=0, backup_host=0)
        taken.append((step, int(batch_np["tokens"].sum())))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch_np.items()}
        if cfg.encoder is not None:
            batch["frames"] = torch.zeros(
                (run.global_batch, cfg.encoder.num_frames, cfg.d_model),
                dtype=dtype_of(cfg), device=device)
        state, metrics = train_step(state, batch)
        coord.heartbeat(0, step)
        loss = float(metrics["loss"])           # waits for the step
        losses.append(loss)
        step_s.append(time.perf_counter() - ts)
        if step % run.log_every == 0:
            rate = (step - start + 1) / (time.time() - t0)
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({rate:.2f} steps/s)", flush=True)
        step += 1
        if run.ckpt_dir and step % run.ckpt_every == 0:
            save_checkpoint(run.ckpt_dir, step, stack_state(cfg, state),
                            extra={"data_step": step})
    if run.ckpt_dir:
        save_checkpoint(run.ckpt_dir, step, stack_state(cfg, state),
                        extra={"data_step": step})
    return {"state": state, "losses": losses, "step_s": step_s,
            "final_step": step, "start_step": start, "taken": taken}


def train_with_restarts(run: TrainRun, max_attempts: int = 4):
    """Crash-recovery wrapper: restart from the latest checkpoint on
    (injected or real) worker failure."""
    for attempt in range(max_attempts):
        try:
            return train(run)
        except WorkerFailure as e:
            print(f"[train] {e} — restarting from checkpoint "
                  f"(attempt {attempt + 1})")
    raise RuntimeError("too many restarts")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced sibling config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = dataclasses.replace(cfg, accum_steps=args.accum)
    out = train_with_restarts(TrainRun(
        cfg=cfg, total_steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir, peak_lr=args.lr,
        device=args.device))
    print(f"[train] done: loss {out['losses'][0]:.4f} → "
          f"{out['losses'][-1]:.4f} over {out['final_step']} steps")


if __name__ == "__main__":
    main()
