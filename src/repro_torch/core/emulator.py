"""Emulation-based validation of the simulator (§4.2, Fig. 5 methodology).

The paper validates its simulator against an emulation on real hardware
(64 Ivy-Bridge nodes, RAPL). Our analogue: the *emulator* measures real
step times of the reduced-config models executing on the card (the
port's kernels, the card's own scheduling noise), builds a measured cost
model from them, and replays the same traces through the same
heuristics. The simulator uses the analytic/roofline model instead.
Agreement in the heuristic *ranking pattern* across power caps — not
magnitudes — is the validation criterion, as in the paper.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.costmodel import CellCost, CostModel
from repro_torch.device import DeviceLike, resolve_device, sync_clock
from repro_torch.models import model as M


def measure_step_time(arch: str, kind: str = "train", seq: int = 64,
                      batch: int = 2, iters: int = 3,
                      device: DeviceLike = None) -> float:
    """Seconds per train step (``loss.backward()`` of the REDUCED config,
    bf16 compute) or per forward (any other ``kind``), host clock after a
    device sync, the mean of ``iters`` after one warm-up call."""
    dev = resolve_device(device)
    cfg = get_arch(arch).reduced()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch_d = {"tokens": torch.zeros((batch, seq), dtype=torch.int32,
                                     device=dev),
               "labels": torch.zeros((batch, seq), dtype=torch.int32,
                                     device=dev)}
    if cfg.frontend == "patch_stub":
        batch_d["patches"] = torch.zeros((batch, cfg.n_prefix_tokens,
                                          cfg.d_model), device=dev)
    if cfg.enc_dec is not None:
        batch_d["frames"] = torch.zeros((batch, cfg.enc_dec.enc_seq,
                                         cfg.d_model), device=dev)

    def fn():
        if kind == "train":
            model.zero_grad(set_to_none=True)
            M.loss_fn(cfg, model, batch_d)[0].backward()
        else:
            with torch.no_grad():
                M.forward(cfg, model, batch_d)
    fn()                                # warm
    t0 = sync_clock(dev)
    for _ in range(iters):
        fn()
    return (sync_clock(dev) - t0) / iters


def measured_cost_model(archs: List[str], shapes: Optional[List[str]] = None,
                        scale: float = 1.0,
                        device: DeviceLike = None) -> CostModel:
    """CostModel whose compute term comes from real measured step times.

    `scale` maps measured seconds to modeled-chip-seconds so the workload
    regime (oversubscription level) matches the simulator's.
    """
    base = CostModel.analytic(archs, shapes)
    shapes = shapes or list(SHAPES)
    cells = {}
    for a in archs:
        t_train = measure_step_time(a, "train", device=device)
        for s in shapes:
            ref = base.cells[(a, s)]
            kind = SHAPES[s].kind
            mult = {"train": 1.0, "prefill": 0.4, "decode": 0.02}[kind]
            t = t_train * mult * scale
            # measured time replaces the dominant term; keep analytic ratios
            total_ref = max(ref.t_compute, ref.t_memory, ref.t_collective)
            f = t / total_ref if total_ref > 0 else 1.0
            cells[(a, s)] = CellCost(ref.t_compute * f, ref.t_memory * f,
                                     ref.t_collective * f, ref.hbm_bytes)
    return CostModel(cells)
