"""The frozen counts of ``portbench/counts/`` against the formulas the
program registers on its ops, at every cell's shapes (a test may import
the program; the count files may not)."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import (flash_attention, flash_attention_backward,
                              ssd_scan, ssd_scan_backward, ssd_scan_state)
from repro_torch.kernels.flash_attention.ops import flash_attention_flops
from repro_torch.kernels.ssd_scan.ops import ssd_scan_flops

# the cells' op shapes: granite train (q, k), mamba2 train and prefill (x, B)
FLASH = [((2, 4096, 16, 64), (2, 4096, 8, 64)),
         ((16, 1024, 16, 64), (16, 1024, 8, 64))]
SSD = [((2, 4096, 64, 64), (2, 4096, 1, 128), 256),
       ((4, 4096, 64, 64), (4, 4096, 1, 128), 256)]


@pytest.mark.parametrize("q,k", FLASH)
def test_flash_counts_are_the_registered_formulas(q, k):
    assert flash_attention.registered_flops(q, k, True) == \
        flash_attention_flops(q, k, True)
    assert flash_attention_backward.registered_flops(q, k, True) == \
        5 * flash_attention_flops(q, k, True) // 2
    assert flash_attention.flops([q, k, k, []]) == flash_attention_flops(
        q, k, True)


@pytest.mark.parametrize("x,b,chunk", SSD)
def test_ssd_counts_are_the_registered_formulas(x, b, chunk):
    assert ssd_scan.registered_flops(x, b, chunk) == ssd_scan_flops(x, b,
                                                                    chunk)
    assert ssd_scan_state.registered_flops(x, b, chunk) == \
        ssd_scan_flops(x, b, chunk)
    assert ssd_scan_backward.registered_flops(x, b, chunk) == \
        3 * ssd_scan_flops(x, b, chunk)
    shapes = [x, x[:3], [x[2]], b, b, []]
    # the roofline's count: the recurrence's least work, under the chunked
    assert ssd_scan.flops(shapes) == 4 * b[3] * x[3] * x[0] * x[1] * x[2]
    assert ssd_scan.flops(shapes) < ssd_scan_flops(x, b, chunk)
    assert ssd_scan_backward.flops(shapes + [x]) == 3 * ssd_scan.flops(shapes)


def test_registered_formulas_are_what_the_program_counts():
    """FlopCounterMode on the program's ops (CPU, small shapes) counts
    exactly the frozen registered formulas."""
    from repro_torch.kernels.flash_attention.ops import flash_attention as fa
    from repro_torch.kernels.ssd_scan.ops import ssd_scan as ss
    q = torch.randn(1, 32, 4, 16)
    k = torch.randn(1, 32, 2, 16)
    with FlopCounterMode(display=False) as fc:
        fa(q, k, k, causal=True)
    assert fc.get_total_flops() == flash_attention.registered_flops(
        q.shape, k.shape, True)
    x, B = torch.randn(1, 64, 2, 8), torch.randn(1, 64, 1, 16)
    with FlopCounterMode(display=False) as fc:
        ss(x, torch.rand(1, 64, 2), -torch.rand(2), B, B, chunk=32)
    assert fc.get_total_flops() == ssd_scan.registered_flops(x.shape,
                                                             B.shape, 32)


def test_bytes_read_once_written_once():
    bf16, f32 = "c10::BFloat16", "float"
    q, k = (2, 4096, 16, 64), (2, 4096, 8, 64)
    n_q, n_k = 2 * 4096 * 16 * 64 * 2, 2 * 4096 * 8 * 64 * 2
    assert flash_attention.nbytes([q, k, k, []], [bf16] * 3) == \
        2 * n_q + 2 * n_k
    assert flash_attention_backward.nbytes([q, k, k, q, []], [bf16] * 4) == \
        3 * n_q + 4 * n_k
    x, b = (2, 4096, 64, 64), (2, 4096, 1, 128)
    shapes, types = [x, x[:3], [64], b, b, []], [bf16, f32, f32, bf16, bf16,
                                                 "Scalar"]
    n_x, n_dt, n_b = 2 * 4096 * 64 * 64 * 2, 2 * 4096 * 64 * 4, 2 * 4096 * 128 * 2
    one = n_x + n_dt + 64 * 4 + 2 * n_b
    assert ssd_scan.nbytes(shapes, types) == one + n_x
    assert ssd_scan_state.nbytes(shapes, types) == one + n_x + 2 * 64 * 64 * 128 * 4
    assert ssd_scan_backward.nbytes(shapes + [x], types + [bf16]) == \
        2 * one + n_x
