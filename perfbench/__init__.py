"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything that judges the port lives here and is
frozen for later changes: the token generator and weight init
(:mod:`.yardstick`), the kernels' work formulas and the card's peaks, the
plain float32 references (:mod:`.reference`), the metric readers
(``metrics/<name>.py``) and the comparison that decides ``correct``
(:mod:`.judge`).  The harness finds a cell's configuration, traffic,
limits and per-layer readers by the names in ``BENCHMARK.json``.
"""
