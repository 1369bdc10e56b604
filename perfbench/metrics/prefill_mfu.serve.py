"""prefill_mfu.serve: the model FLOPs of every prefill of the window (a
forward over each prompt, the head at its last position) over the summed
prefill seconds that ``serve_batch`` reports, as a per cent of the card's
bf16 peak."""

from perfbench.yardstick import peaks


def read(ctx):
    rec, cell = ctx["record"], ctx["cell"]
    spent = sum(rec.get("prefill_s", []))
    if spent <= 0:
        return None
    tr = cell.traffic
    flops = cell.ref.forward_flops(cell.spec, tr["batch"], tr["prompt_len"], 1)
    return 100.0 * flops * len(rec["prefill_s"]) / spent / peaks.BF16_FLOPS
