"""train_mfu: the model FLOPs of the window's training steps (the frozen
formula of the configuration's reference family: three times a forward
over every position, no credit for recomputation) over the window's
seconds, as a per cent of the card's bf16 peak."""

from perfbench.yardstick import peaks


def read(ctx):
    rec, cell = ctx["record"], ctx["cell"]
    if "steps" not in rec or rec["seconds"] <= 0:
        return None
    tr = cell.traffic
    flops = cell.ref.train_flops(cell.spec, tr["batch"], tr["seq_len"])
    return 100.0 * flops * rec["steps"] / rec["seconds"] / peaks.BF16_FLOPS
