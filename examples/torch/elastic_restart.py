"""Elastic restart on the PyTorch/CUDA port: lose a node mid-run,
re-mesh, reshard, resume — the counterpart of
``examples/elastic_restart.py``.

  1. a Coordinator detects a dead worker from missed heartbeats;
  2. ``replan_mesh`` shrinks the data axis to the surviving chip count
     while preserving the model axis (TP layout is layout-critical);
  3. ``resharding_plan`` emits the deterministic old-shard → new-shard map;
  4. training resumes from the latest checkpoint with the new plan, and the
     seekable TokenSource replays the batch stream exactly-once (the
     training runs on the card).

The training runs the JAX example's reduced config (head dim 16, which
the flash kernel runs zero-padded to 32 on the card).

Run:  PYTHONPATH=src python examples/torch/elastic_restart.py          # card
      PYTHONPATH=src python examples/torch/elastic_restart.py --device cpu
"""

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.reduced import reduced
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import TrainRun, train
from repro_torch.runtime.elastic import MeshPlan, replan_mesh, resharding_plan
from repro_torch.runtime.fault_tolerance import (Coordinator, RunState,
                                                 WorkerFailure)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)   # no card: raises

    # --- failure detection -------------------------------------------------
    coord = Coordinator(num_workers=256, miss_threshold=2)
    for step in (1, 2):
        for w in range(256):
            if w != 137:                      # chip 137 dies silently
                coord.heartbeat(w, step)
        ev = coord.tick(step, checkpoint_step=100)
    assert ev and ev.worker == 137 and coord.state == RunState.RECOVERING
    print(f"[elastic] worker {ev.worker} declared dead at step {ev.step}; "
          f"restart from checkpoint step {ev.restart_step}")

    # --- re-mesh ------------------------------------------------------------
    old = MeshPlan((16, 16), ("data", "model"))
    new = replan_mesh(old, surviving_devices=255)
    print(f"[elastic] mesh {old.shape} -> {new.shape} "
          f"({new.num_devices} chips; model axis preserved)")
    plan = resharding_plan(old, new, batch_dim=256)
    print(f"[elastic] per-device batch {256 // 16} -> "
          f"{plan['per_device_batch']}; first assignment: "
          f"{plan['assignments'][0]}")

    # --- resume training (reduced width, the same code path) ---------------
    cfg = dataclasses.replace(reduced(get_config("internlm2-1.8b")),
                              num_layers=2)
    with tempfile.TemporaryDirectory(prefix="elastic_ckpt_") as ckpt:
        run = TrainRun(cfg=cfg, total_steps=30, global_batch=8, seq_len=64,
                       ckpt_dir=ckpt, ckpt_every=10, peak_lr=1e-3,
                       device=str(device))
        try:
            train(dataclasses.replace(run, fail_at_step=15))
        except WorkerFailure as e:
            print(f"[elastic] {e} — resuming on the shrunken mesh")
        out = train(run)                      # restores from step 10
    assert out["start_step"] == 10 and out["final_step"] == 30
    assert np.isfinite(out["losses"]).all()
    coord.recover()
    print(f"[elastic] resumed and finished on {device}: loss "
          f"{out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}; "
          f"coordinator state = {coord.state.value}")
    return out


if __name__ == "__main__":
    main()
