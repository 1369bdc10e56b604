"""Plain float32 references of the benchmark's models, written from their
published descriptions in plain PyTorch: no kernel, cache or batching of
the port, and nothing imported from it (``perfbench/tests`` checks the
imports).  Each module serves one family: ``init_params`` makes the
weights a cell hands to both the port and the reference, ``loss`` and
``logits_at`` compute in float32 with TF32 off (``precision="fp8"``: the
control, every GEMM's operands rounded to float8 e4m3), ``forward_flops``
is the frozen model-FLOP formula, and ``program_fields`` the sizes the
port's own configuration must show."""
