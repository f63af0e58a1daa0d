"""qwen2-vl-72b [arXiv:2409.12191; hf].  M-RoPE, dynamic resolution.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  Vision frontend is
a STUB: input_specs provides precomputed patch embeddings (dim 1280); the
backbone projects them and prepends to the text tokens.  M-RoPE rotates the
head dim in (temporal, height, width) sections from 3-axis position ids.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, mrope=True, frontend="vision_stub",
    frontend_dim=1280, rope_theta=1e6,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, frontend_dim=32)
