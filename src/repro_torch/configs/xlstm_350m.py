"""xlstm-350m [arXiv:2405.04517; unverified].

24L d_model=1024 4 heads; sLSTM + mLSTM blocks at 7:1 (one sLSTM per 8
layers), vocab 50304.  d_ff=0 per assignment: the xLSTM blocks carry their
own 2x up-projections instead of a separate FFN.
"""
import dataclasses
from repro_torch.models.common import ArchConfig, XLSTMCfg

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    xlstm=XLSTMCfg(slstm_every=8, proj_factor=2.0),
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab=128,
        xlstm=XLSTMCfg(slstm_every=2, proj_factor=2.0, chunk=16))
