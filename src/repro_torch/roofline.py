"""Three-term roofline analysis from the dry-run's per-device counters.

  compute    = HLO_FLOPs(per-device) / (peak_FLOP/s · f_DVFS)
  memory     = HLO_bytes(per-device) / HBM_bw
  collective = collective_bytes(per-device, ring model) / link_bw

The dry-run counts each device's local ops and collectives (the JAX
package reads XLA's per-partition ``cost_analysis`` and compiled HLO), so
no extra division by chip count is needed.
MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) is the *useful* compute;
MODEL/HLO ratio flags remat or dispatch waste.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

from repro_torch import hardware as hw
from repro_torch.configs import ArchConfig, ShapeSpec


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw per-device quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    # derived terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / (HLO_FLOPs · chips)
    roofline_fraction: float     # t_bound / t_total-ish: max-term / sum proxy
    # memory fit
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    fits_hbm: bool = True
    note: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)

    @property
    def t_step(self) -> float:
        """Roofline step-time estimate: the dominant term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_step_serial(self) -> float:
        """No-overlap upper bound."""
        return self.t_compute + self.t_memory + self.t_collective


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6·N_active·D for train (fwd+bwd); 2·N_active·D for inference."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def raw_costs(run):
    """(flops, bytes, collective_bytes, collective_counts) per device from
    a dry run's counters (``launch.dryrun.CellRun``: ``flops``, ``bytes``
    and ``collectives``, a ``utils.hlo.CollectiveStats``)."""
    coll = run.collectives
    return (float(run.flops), float(run.bytes), coll.total_bytes,
            dict(coll.counts))


def analyze_costs(flops: float, nbytes: float, coll_bytes: float,
                  coll_counts: Dict[str, int], cfg: ArchConfig,
                  shape: ShapeSpec, mesh_name: str, chips: int, *,
                  dvfs_f: float = 1.0, mem=None, note: str = ""
                  ) -> RooflineReport:
    t_c = flops / (hw.PEAK_FLOPS_BF16 * dvfs_f)
    t_m = nbytes / hw.HBM_BW
    t_x = coll_bytes / hw.ICI_LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)

    mf = model_flops(cfg, shape)
    useful = mf / max(1.0, flops * chips)
    # roofline fraction: useful-compute time over the dominant-term time —
    # "how close does the useful work run to the hardware bound".
    t_useful = mf / (chips * hw.PEAK_FLOPS_BF16 * dvfs_f)
    frac = t_useful / max(terms.values()) if max(terms.values()) > 0 else 0.0

    arg_b, temp_b, out_b = mem if mem else (0, 0, 0)
    fits = (arg_b + temp_b) <= hw.HBM_BYTES

    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes,
        collective_bytes=coll_bytes,
        collective_counts={k: v for k, v in coll_counts.items() if v},
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops_global=mf, useful_ratio=useful,
        roofline_fraction=frac, arg_bytes=arg_b, temp_bytes=temp_b,
        out_bytes=out_b, fits_hbm=fits, note=note)


def analyze(run, cfg: ArchConfig, shape: ShapeSpec, mesh_name: str,
            chips: int, *, dvfs_f: float = 1.0,
            note: str = "") -> RooflineReport:
    """The report of a dry run (``launch.dryrun.CellRun``): its costs and
    its memory (arguments, the peak beyond them, new results)."""
    flops, nbytes, coll_b, counts = raw_costs(run)
    mem = (run.arg_bytes, run.temp_bytes, run.out_bytes)
    return analyze_costs(flops, nbytes, coll_b, counts, cfg, shape,
                         mesh_name, chips, dvfs_f=dvfs_f, mem=mem, note=note)


def format_table(reports) -> str:
    head = (f"{'arch':24s} {'shape':12s} {'mesh':9s} "
            f"{'t_comp(s)':>10s} {'t_mem(s)':>10s} {'t_coll(s)':>10s} "
            f"{'bound':>10s} {'useful':>7s} {'roofl%':>7s} "
            f"{'HBM(GiB)':>9s} fit")
    lines = [head, "-" * len(head)]
    for r in reports:
        hbm = (r.arg_bytes + r.temp_bytes) / 2**30
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:9s} "
            f"{r.t_compute:10.4f} {r.t_memory:10.4f} {r.t_collective:10.4f} "
            f"{r.bottleneck:>10s} {r.useful_ratio:7.3f} "
            f"{100*r.roofline_fraction:6.1f}% {hbm:9.2f} "
            f"{'Y' if r.fits_hbm else 'OVER'}")
    return "\n".join(lines)


def save_reports(reports, path: str):
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in reports], f, indent=1)
