"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512, MoE 32 experts top-8,
vocab 49155.
"""
import dataclasses
from repro_torch.models.common import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoECfg(num_experts=32, top_k=8, d_expert=512),
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=128,
        moe=MoECfg(num_experts=4, top_k=2, d_expert=32))
