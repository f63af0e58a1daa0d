"""whisper-medium [arXiv:2212.04356; unverified].  Enc-dec; conv frontend stub.

24L encoder + 24L decoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The conv frontend is a STUB: input_specs provides post-conv frame embeddings
(dim 80 mel -> we use frontend_dim=1024 post-conv features).  Decoder length
is seq_len // 8 for train/prefill shapes (DESIGN.md).
"""
import dataclasses
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, enc_dec=True, n_enc_layers=24,
    frontend="audio_stub", frontend_dim=1024,
)

def smoke():
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, frontend_dim=32)
