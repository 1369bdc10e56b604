"""decode_ms_per_token.serve: the summed decode seconds that
``serve_batch`` reports over the window's decode steps (each step one
token for every row of its call), in milliseconds."""


def read(ctx):
    rec, cell = ctx["record"], ctx["cell"]
    steps = len(rec.get("decode_s", [])) * cell.traffic["gen_tokens"]
    if steps <= 0:
        return None
    return 1e3 * sum(rec["decode_s"]) / steps
