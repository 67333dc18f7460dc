"""The shapes and tolerances at which the port's kernels are checked: the
sweeps of the JAX package's kernel tests (tests/test_kernels_window.py,
tests/test_kernels_flash.py, tests/test_kernels_ssd.py) with their
tolerances, and the full width of the configurations the repo supports.
chip_smoke.py and the tests read them from here, so the copies cannot
drift apart."""
from __future__ import annotations

from repro_torch.configs import get_arch

# window_agg: (T, C, window, stride, agg, dtype). window_aggregate within
# WINDOW_TOL[dtype] (atol and rtol) of its reference; the segment pass's
# sums within SEGMENT_SUM_RTOL[dtype] · Σ|x| of the segment, its max and
# min bit-equal.
WINDOW_SWEEP = ((600, 5, 180, 60, "max", "float32"),
                (600, 5, 180, 60, "mean", "float32"),
                (1024, 130, 256, 64, "sum", "float32"),
                (777, 3, 120, 40, "min", "float32"),
                (2000, 1, 500, 100, "mean", "float32"),
                (512, 128, 128, 128, "max", "bfloat16"))
WINDOW_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
SEGMENT_SUM_RTOL = {"float32": 1e-5, "bfloat16": 1e-1}

# flash attention: (B, Sq, Skv, H, KV, d, causal, dtype), |err| <=
# FLASH_TOL[dtype]. The eighth case is causal with Sq > Skv, so its first
# rows see no key. The bf16 cases after it reach the edges of the bf16
# kernel's tiling (128 queries by 128 keys, 64-byte swizzle at d = 32): a
# ragged length, the smallest head dim, Sq > Skv.
FLASH_SWEEP = ((2, 256, 256, 4, 2, 64, True, "float32"),
               (1, 200, 200, 4, 4, 64, True, "float32"),        # ragged
               (2, 128, 384, 8, 2, 128, False, "float32"),      # cross-ish
               (1, 256, 256, 2, 1, 32, True, "float32"),        # MQA
               (1, 384, 384, 3, 3, 64, True, "float32"),        # odd heads
               (2, 256, 256, 4, 2, 64, True, "bfloat16"),
               (1, 128, 256, 8, 8, 128, True, "bfloat16"),
               (1, 256, 128, 2, 1, 64, True, "float32"),
               (1, 256, 256, 2, 1, 32, True, "bfloat16"),       # d = 32
               (1, 200, 200, 4, 2, 64, True, "bfloat16"),       # ragged
               (1, 256, 128, 2, 1, 64, True, "bfloat16"))       # Sq > Skv
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the flash backward (bf16; the JAX package has no backward kernel, so its
# gradients come from jax.grad of models.layers.chunked_attention): (B,
# Sq, Skv, H, KV, d, causal). Every head dim; GQA rep 1, 2, 3, 4 and 5;
# Sq < Skv and Sq > Skv, causal and not; query lengths over several tiles
# of both passes. The last four sum dq over several key tiles of 128: d 16
# with rows that see no key (causal, Sq > Skv), rep 4; non-causal Sq <
# Skv and Sq > Skv; rep 4 causal over three key tiles. Each gradient within
# FLASH_BWD_RTOL · max|g| of jax.grad (the two round their bf16 products
# at different points).
FLASH_BWD_SWEEP = ((2, 64, 64, 4, 2, 16, True),
                   (1, 100, 200, 3, 3, 16, False),     # rep 1, Sq < Skv
                   (1, 130, 130, 4, 2, 32, True),
                   (1, 96, 160, 6, 2, 32, True),       # rep 3, Sq < Skv
                   (1, 200, 150, 5, 1, 64, False),     # rep 5, Sq > Skv
                   (1, 160, 96, 4, 2, 64, True),       # causal, Sq > Skv
                   (2, 96, 224, 2, 1, 128, False),     # cross-attention
                   (1, 300, 300, 4, 2, 128, True),
                   (1, 330, 260, 4, 1, 16, True),      # d 16, Sq > Skv
                   (2, 96, 300, 4, 4, 64, False),      # rep 1, Sq < Skv
                   (1, 300, 170, 8, 4, 128, False),    # rep 2, Sq > Skv
                   (1, 260, 260, 8, 2, 32, True))      # rep 4
FLASH_BWD_RTOL = 5e-2

# SSD scan: (B, L, H, P, G, N, chunk, dtype), |err| <= SSD_RTOL[dtype] ·
# max|plain|.
SSD_SWEEP = ((2, 256, 4, 64, 1, 128, 128, "float32"),
             (1, 512, 2, 32, 1, 64, 128, "float32"),
             (2, 200, 4, 16, 2, 32, 64, "float32"),             # pad + groups
             (1, 128, 8, 64, 1, 128, 32, "float32"),
             (1, 256, 4, 64, 1, 128, 128, "bfloat16"),
             (2, 200, 4, 16, 2, 32, 64, "bfloat16"))            # pad + groups
SSD_RTOL = {"float32": 1e-4, "bfloat16": 1e-1}
# the SSD backward (the JAX package trains mamba2 by jax.grad of
# models.ssm.ssd_chunked and has no backward kernel): each gradient within
# SSD_BWD_RTOL[dtype] · max|g| of jax.grad at the SSD_SWEEP shapes
SSD_BWD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}

# Full width, 4,096 positions (the train_4k shape). In bf16 the sweeps'
# limits come close to the size of what they compare (a late row of
# random causal attention has |o| near 0.03), so there flash is held per
# query row, |err| <= FULL_FLASH_BF16_ROW_RTOL · max|plain| of the row
# (one bf16 step is at most 2^-7 of it), and the SSD at FULL_SSD_RTOL. In
# fp32 the sweeps' limits hold.
FULL_SEQ = 4096
FULL_FLASH_BF16_ROW_RTOL = 2e-2
FULL_SSD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}

# A float32 train step on the card against the same step on the CPU: each
# parameter's gradient within STEP_GRAD_RTOL · |g| + STEP_GRAD_ATOL ·
# max|g| of that tensor's (tests/test_torch_train.py's bound between the
# port and the JAX package), or STEP_SSM_GRAD_ATOL · max|g| in place of the
# second term in a model with SSM layers. Their gradients pass through the
# SSD's dt and A, each per head a float32 sum of P·N (dt) or B·L·P·N (A)
# terms that cancel, so they round with the order of the sums, and so does
# every gradient upstream of them: on the CPU alone, 1 thread against 6
# moves mamba2-1.3b's by up to 1.1e-4 · max|g| (A_log; the embedding's
# 9.6e-6) at its width, qwen3-1.7b's by 2.4e-6
# (tests/test_torch_grad.py::test_step_gradients_depend_on_the_order_of_sums
# holds each to half of its bound).
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-5
STEP_SSM_GRAD_ATOL = 3e-4


def full_widths():
    """(flash, SSD) shapes at full width: qwen3-1.7b attention as (B, Sq,
    Skv, H, KV, d, causal) and mamba2-1.3b's SSD as (B, L, H, P, G, N,
    chunk), both at FULL_SEQ positions."""
    qwen, mamba = get_arch("qwen3-1.7b"), get_arch("mamba2-1.3b")
    s = mamba.ssm
    return ((1, FULL_SEQ, FULL_SEQ, qwen.n_heads, qwen.n_kv_heads,
             qwen.head_dim, True),
            (1, FULL_SEQ, s.n_heads(mamba.d_model), s.head_dim, s.n_groups,
             s.d_state, s.chunk_size))
