"""olmoe-1b-7b [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA kv=16) per-expert d_ff=1024, MoE 64 experts top-8,
vocab 50304.
"""
import dataclasses
from repro_torch.models.common import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoECfg(num_experts=64, top_k=8, d_expert=1024),
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=128,
        moe=MoECfg(num_experts=8, top_k=2, d_expert=32))
