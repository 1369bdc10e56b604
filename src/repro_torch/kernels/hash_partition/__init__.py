"""Hash-partition kernel family: CUDA kernels (hash_partition.py), plain
torch versions (ref.py), device dispatch (ops.py)."""
