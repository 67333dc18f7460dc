"""Qwen3-1.7B — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import ArchConfig, register

QWEN3_1P7B = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
))
