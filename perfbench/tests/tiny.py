"""Small cells for the CPU tests: the port's ``--reduced`` sibling of a
configuration (float32, or bfloat16 where asked), a configuration file
that states its sizes, and a traffic mix scaled down from the real one."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from perfbench import bench

ROOT = Path(bench.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())

TRAFFIC = {
    "train": {"driver": "train", "batch": 2, "seq_len": 32,
              "checked_steps": 3, "peak_lr": 0.0015, "total_steps": 10,
              "trace_steps": 1},
    "serve": {"driver": "serve", "batch": 2, "prompt_len": 24,
              "gen_tokens": 4, "calls_per_s": 1000.0, "warmup_calls": 1,
              "check_requests": 3, "trace_calls": 1},
}


#: the published widths of a transformer, at two layers and a small
#: vocabulary: logits as large as the full model's, which the serving
#: cell's limit is set against
WIDE = {"d_model": 2048, "num_heads": 16, "num_kv_heads": 8, "head_dim": 128,
        "d_ff": 1024}


def program_config(arch: str, dtype: str = "float32", **sizes):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    return dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype,
                               **sizes)


def spec_for(cfg) -> dict:
    """A configuration file stating the sizes of the port's ``cfg``."""
    base = {"name": cfg.name, "program_arch": cfg.name,
            "layout": {"vocab_pad_multiple": 256}}
    if cfg.ssd is not None:
        s = cfg.ssd
        return dict(base, reference="mamba2", config={
            "d_model": cfg.d_model, "n_layer": cfg.num_layers,
            "vocab_size": cfg.vocab_size,
            "tie_embeddings": cfg.tie_embeddings, "d_state": s.state,
            "d_conv": s.conv_width, "expand": s.d_inner // cfg.d_model,
            "headdim": s.d_inner // s.nheads, "chunk_size": s.chunk,
            "torch_dtype": cfg.param_dtype})
    return dict(base, reference="transformer", config={
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": cfg.param_dtype})


def cell(workload: str, dtype: str = "float32", sizes=None,
         **traffic) -> bench.Cell:
    """The real cell ``workload`` with its metrics and limits, on the port's
    reduced configuration (``sizes`` replacing some of its fields) and a
    small traffic mix of the same driver."""
    real = bench.load_cell(workload)
    cfg = program_config(real.spec["program_arch"], dtype, **(sizes or {}))
    c = bench.Cell(workload=real.workload, spec=spec_for(cfg),
                   traffic=dict(TRAFFIC[real.traffic["driver"]], **traffic),
                   limits=real.limits, e2e=real.e2e,
                   per_layer=real.per_layer)
    return bench.attach_program(c, cfg)
