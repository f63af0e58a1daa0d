"""zamba2-7b [arXiv:2411.15242; unverified].  Mamba2 + shared attn blocks.

81L d_model=3584; the assignment's 32H (kv=32) d_ff=14336 describe the
SHARED attention/MLP block; ssm_state=64.  We map the 81 layers onto 12
macro-blocks of 6 Mamba2 layers + 1 shared-block invocation (72 Mamba2
layers + 12 shared applications ~ 81 published layers; the shared block
has ONE set of parameters, Zamba2's hallmark).
"""
import dataclasses
from repro_torch.models.common import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, attn_every=6,
    ssm=SSMCfg(d_state=64, head_dim=64, expand=2),
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, attn_every=2, ssm=SSMCfg(d_state=8, head_dim=8, expand=2, chunk=16))
