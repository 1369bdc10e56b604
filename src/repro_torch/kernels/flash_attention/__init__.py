"""Flash-attention kernel family: CUDA kernel (flash_attention.py), plain
torch version (ref.py), device dispatch (ops.py)."""
