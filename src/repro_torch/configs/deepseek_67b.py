"""deepseek-67b [arXiv:2401.02954; hf].  LLaMA-arch.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab=128)
