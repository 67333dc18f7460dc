"""IBM Granite 4.0-H Small (32B-A9B) — hybrid Mamba-2 / NoPE attention,
an MoE of 72 routed experts top-10 and a shared expert in every layer.
[hf:ibm-granite/granite-4.0-h-small; config.json]

40 layers: attention (GQA 32 / 8 heads of 128, no positional encoding) at
layers 5, 15, 25 and 35, Mamba-2 (128 SSD heads of 64, d_state 128, one
group) everywhere else, so the pattern has a period of 10 with attention
at offset 5. Each layer's MoE holds ``moe.n_experts`` of the
``routed_experts`` its router scores: this registration holds all 72; a
deployment that divides each layer's experts over chips sets the share.
The muP multipliers on the embedding (12), the residual branches (0.22)
and attention's scores (1/128) are the published ones, as is the bias of
the Mamba-2 convolution; the published logits scaling (÷ 16) is not
implemented: the logits are the unscaled product.
"""
from repro_torch.configs import (ArchConfig, HybridConfig, MoEConfig, SSMConfig,
                                 register)

GRANITE_4_0_H_SMALL = register(ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=0,
    vocab_size=100352,
    norm_eps=1e-5,
    tie_embeddings=True,
    positional="nope",
    moe=MoEConfig(n_experts=72, top_k=10, d_ff_expert=768),
    routed_experts=72,
    shared_expert_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    ssm_conv_bias=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    hybrid=HybridConfig(attn_period=10, attn_offset=5),
    source="hf:ibm-granite/granite-4.0-h-small",
))
