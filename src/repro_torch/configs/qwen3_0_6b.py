"""qwen3-0.6b [hf:Qwen/Qwen3-8B family; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936; qk-norm; head_dim
128 (Qwen3 uses explicit 128 regardless of d_model/n_heads).
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128)
