"""Qwen3-14B — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs import ArchConfig, register

QWEN3_14B = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
))
