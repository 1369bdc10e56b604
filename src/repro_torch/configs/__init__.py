"""Arch config registry: one module per assigned architecture (a copy of
the JAX package's ``configs/``: plain dataclasses, no framework)."""
from .base import (ArchConfig, LayerSpec, ShapeSpec, SHAPES, get_config,
                   list_archs, shapes_for)
from . import (whisper_small, llama4_maverick_400b_a17b, deepseek_v2_236b,
               gemma2_27b, gemma_7b, qwen15_110b, internlm2_1_8b,
               chameleon_34b, recurrentgemma_9b, mamba2_370m)
