"""h2o-danube-3-4b [arXiv:2401.16818; unverified].  llama+mistral mix, SWA.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; sliding window 4096.
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, sliding_window=4096,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, sliding_window=16)
