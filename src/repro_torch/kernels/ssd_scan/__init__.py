"""Chunked SSD kernel family: CUDA kernel (ssd_scan.py), plain torch version
(ref.py), device dispatch (ops.py)."""
