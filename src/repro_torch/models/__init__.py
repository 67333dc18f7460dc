"""The language models' serving path, ported from the JAX package's
``models/``: layers (norms, positions, attention through the flash
attention op, SwiGLU), the Mamba-2 mixer (the SSD op), MoE, int8 KV
quantization and the assembled models (``model``)."""
