"""Whisper-medium — enc-dec audio backbone; conv frontend STUB.
[arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers (d=1024, 16H MHA, d_ff=4096). The conv
frontend is stubbed: ``input_specs()`` supplies precomputed 1500-frame
embeddings. Sinusoidal positions (whisper uses no RoPE). Decode shapes
exercise the decoder self-attn KV + cross-attn cache; 32k decode KV is
architecturally inflated vs. real Whisper (448 ctx) but lowered as assigned.
"""
from repro_torch.configs import ArchConfig, EncDecConfig, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=51865,  # padded to 51968 for TP sharding
    enc_dec=EncDecConfig(n_enc_layers=24, enc_seq=1500),
    frontend="audio_stub",
    positional="sinusoidal",
    source="arXiv:2212.04356",
))
