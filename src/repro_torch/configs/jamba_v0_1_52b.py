"""Jamba-v0.1-52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

The Mamba mixer is realized with the SSD (Mamba-2) formulation — the TPU
adaptation recasts the selective scan as chunked matmuls mapping onto the
MXU (DESIGN §2). Attention at index 4 of every 8-layer period; MoE replaces
the MLP on every other layer (offset 1).
"""
from repro_torch.configs import ArchConfig, HybridConfig, MoEConfig, SSMConfig, register

JAMBA_V0_1 = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                  every_n_layers=2, moe_offset=1),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(attn_period=8, attn_offset=4),
    source="arXiv:2403.19887",
))
