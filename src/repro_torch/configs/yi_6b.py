"""yi-6b [arXiv:2403.04652; hf].  LLaMA-arch GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
        vocab=128)
