"""Granite-3.0-1B-A400M — MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs import ArchConfig, MoEConfig, register

GRANITE_MOE = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab_size=49155,  # padded to 49408 for TP sharding (DESIGN §4)
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
