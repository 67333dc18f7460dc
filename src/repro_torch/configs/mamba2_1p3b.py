"""Mamba2-1.3B — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]

48 layers, d_model=2048, d_inner=4096, head_dim=64 (64 SSD heads),
d_state=128, attention-free (d_ff=0: the SSD mixer is the whole block,
matching the published Mamba-2 block which has no separate MLP).
"""
from repro_torch.configs import ArchConfig, SSMConfig, register

MAMBA2_1P3B = register(ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,        # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,           # no MLP: pure SSD blocks
    vocab_size=50280,  # padded to 50432 for TP sharding
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
