"""InternVL2-76B — VLM; InternViT frontend STUB + 76B LM backbone.
[arXiv:2404.16821; unverified]

The assigned cell is the LM backbone (80L / d=8192 / 64H GQA kv=8 /
d_ff=28672 / vocab=128256, llama-3-70B-class). The vision tower is stubbed:
``input_specs()`` provides 256 pre-projected patch embeddings as a prefix.
"""
from repro_torch.configs import ArchConfig, register

INTERNVL2_76B = register(ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    frontend="patch_stub",
    n_prefix_tokens=256,
    grad_accum=16,  # 80 layers × d=8192: remat residuals need small microbatches
    source="arXiv:2404.16821",
))
