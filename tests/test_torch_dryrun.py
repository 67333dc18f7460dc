"""The port's dry-run (``launch/dryrun.py``) against the JAX package's, on
the CPU.

* Per-device FLOPs of three cells at ``reduced()`` width on a 2×2 mesh
  (seq 64, batch 8: qwen3-1.7b train and prefill, olmoe-1b-7b train) lie
  within ``FLOP_BAND`` of the JAX package's ``extrapolated_costs`` on 4
  fake XLA CPU devices, which runs in a child process started when the
  module's first test asks for it (its backend is initialized before
  ``repro.launch.dryrun`` is imported, whose import would ask for 512
  devices). The band is not tighter because the two count different
  things: XLA counts elementwise work (norms, softmax, rope, the
  optimizer) and the whole [B, S, V] one-hot of the reference's loss;
  the port counts matrix products and the custom ops' formulas (causal
  attention by the kept pairs), and its loss gathers no one-hot. The
  measured ratios were 0.906, 0.786 and 0.848 (PERF.md).
* The collectives are reported under ``CollectiveStats``' kinds, the
  nonzero ones, and agree with ``CommDebugMode``'s count.
* Decode cells run batch- and sequence-sharded and write their caches
  in place.
* The fake impls give the real ops' output shapes and types.
* ``hillclimb.rule_override`` restores the rules, also on an error.
* ``dryrun.main`` runs a production cell (smollm-135m prefill_32k on a
  fake 16×16 world) to its report.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch.configs import ShapeSpec, get_arch
from repro_torch.kernels import window_agg  # noqa: F401  (registers its op)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hillclimb as HC

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLOP_BAND = (0.75, 1.33)
CELLS = [("qwen3-1.7b", "train"), ("qwen3-1.7b", "prefill"),
         ("olmoe-1b-7b", "train")]
REF_TIMEOUT_S = 120

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax
    assert len(jax.devices()) == 4          # the backend, before dryrun
    from jax.sharding import AxisType
    from repro.configs import ShapeSpec, get_arch
    from repro.launch import dryrun as DR
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, kind in json.loads(sys.argv[1]):
        cfg = get_arch(arch).reduced()
        f, b, c, n = DR.extrapolated_costs(cfg, ShapeSpec(kind, 64, 8, kind),
                                           mesh, verbose=False)
        out[f"{arch}/{kind}"] = [float(f), float(b), float(c), n]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's costs of CELLS, from a child process that starts
    at the first request and runs beside the port's dry-runs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                             json.dumps(CELLS)], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    result = {}

    def get():
        if not result:
            try:
                out, err = proc.communicate(timeout=REF_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                pytest.fail(f"the reference's dry-run took over "
                            f"{REF_TIMEOUT_S} s")
            assert proc.returncode == 0, err[-3000:]
            result.update(json.loads(out.splitlines()[-1]))
        return result
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def world():
    """A fake world of 4 ranks in this process, destroyed after the
    module (files share a worker one after another)."""
    DR.ensure_fake_world(4)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_runs(world, reference):
    from repro_torch.launch.mesh import make_dev_mesh
    reference  # started first: it runs while the port's cells run
    mesh = make_dev_mesh(2, 2, device_type="cpu")
    return {f"{a}/{k}": DR.lower_cell(get_arch(a).reduced(),
                                      ShapeSpec(k, 64, 8, k), mesh,
                                      verbose=False)
            for a, k in CELLS}


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in CELLS])
def test_dryrun_flops_within_band_of_reference(port_runs, reference, cell):
    ref_flops = reference()[cell][0]
    run = port_runs[cell]
    ratio = run.flops / ref_flops
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (cell, run.flops,
                                                   ref_flops, ratio)
    print(f"{cell}: port {run.flops:.4e} reference {ref_flops:.4e} "
          f"ratio {ratio:.3f}")
    # a reading, not a gate: the port's bytes are an upper estimate (every
    # op reads and writes its operands), XLA's the fused program's
    ref_bytes = reference()[cell][1]
    print(f"{cell}: bytes port {run.bytes:.4e} reference {ref_bytes:.4e} "
          f"ratio {run.bytes / ref_bytes:.3f}")
    flops, nbytes, coll, counts = RL.raw_costs(run)
    assert (flops, nbytes) == (run.flops, run.bytes) and coll >= 0
    arch, kind = cell.split("/")
    rep = RL.analyze(run, get_arch(arch).reduced(), ShapeSpec(kind, 64, 8,
                                                              kind),
                     "2x2", 4)
    assert rep.hlo_flops == run.flops and rep.useful_ratio > 0
    assert run.peak_bytes >= run.arg_bytes > 0


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k in CELLS])
def test_collectives_reported(port_runs, reference, cell):
    run = port_runs[cell]
    kinds = set(run.collectives.counts)
    assert kinds == {"all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all"}
    nonzero = {k for k, v in run.collectives.counts.items() if v}
    ref_nonzero = {k for k, v in reference()[cell][3].items() if v}
    # both sides all-reduce; the trained cells gather FSDP weights on both
    assert "all-reduce" in nonzero and "all-reduce" in ref_nonzero
    if cell.endswith("train"):
        assert "all-gather" in nonzero and "all-gather" in ref_nonzero
    assert all(run.collectives.bytes_by_kind[k] > 0 for k in nonzero)
    rep_counts = RL.raw_costs(run)[3]
    assert {k for k, v in rep_counts.items() if v} == nonzero


def test_collective_counts_equal_comm_debug_mode(world):
    """CommDebugMode, outside the dry-run's own modes, counts the same
    collectives as the dry-run's counter."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.mesh import make_dev_mesh
    mesh = make_dev_mesh(2, 2, device_type="cpu")
    with CommDebugMode() as comm:
        run = DR.lower_cell(get_arch("qwen3-1.7b").reduced(),
                            ShapeSpec("p", 64, 8, "prefill"), mesh,
                            verbose=False)
    assert comm.get_total_counts() == sum(run.collectives.counts.values())
    assert comm.get_total_counts() > 0


DECODE_CELLS = [("qwen3-1.7b", 8), ("qwen3-1.7b", 1), ("mamba2-1.3b", 8),
                ("mamba2-1.3b", 1)]


@pytest.fixture(scope="module")
def decode_runs(world):
    from repro_torch.launch.mesh import make_dev_mesh
    mesh = make_dev_mesh(2, 2, device_type="cpu")
    return {(a, B): DR.lower_cell(get_arch(a).reduced(),
                                  ShapeSpec("decode", 64, B, "decode"), mesh,
                                  verbose=False)
            for a, B in DECODE_CELLS}


@pytest.mark.parametrize("arch,batch", DECODE_CELLS)
def test_decode_cells_update_the_caches_in_place(decode_runs, arch, batch):
    """A decode cell runs on the fake mesh, batch-sharded (8) and with the
    cache sharded on the sequence (1, long context), and writes every
    cache in place: its only new storage is the logits, the same for the
    SSM (conv window and state) as for attention (k and v at ``pos``)."""
    run = decode_runs[(arch, batch)]
    assert run.flops > 0 and run.arg_bytes > 0
    assert run.collectives.counts["all-reduce"] > 0
    assert run.out_bytes == decode_runs[("qwen3-1.7b", batch)].out_bytes > 0


def _fake_vs_real(fn, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    real = fn(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode:
        fake = fn(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_impls_match_real_ops(dtype):
    g = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g).to(dtype)
    ops = torch.ops.repro_torch
    for B, Sq, Skv, H, KV, d, causal in ((2, 32, 32, 4, 2, 16, True),
                                         (1, 16, 24, 2, 2, 8, False)):
        q, k, v = rn(B, Sq, H, d), rn(B, Skv, KV, d), rn(B, Skv, KV, d)
        _fake_vs_real(ops.flash_attention, q, k, v, causal)
        _fake_vs_real(ops.flash_attention_backward, q, k, v, rn(B, Sq, H, d),
                      causal)
    x, dt = rn(2, 48, 4, 8), torch.rand(2, 48, 4, generator=g).to(dtype)
    A = -torch.rand(4, generator=g)
    Bm, C = rn(2, 48, 2, 8), rn(2, 48, 2, 8)
    _fake_vs_real(ops.ssd_scan, x, dt, A, Bm, C, 16)
    _fake_vs_real(ops.ssd_scan_state, x, dt, A, Bm, C, 16)
    _fake_vs_real(ops.ssd_scan_backward, x, dt, A, Bm, C, 16, rn(2, 48, 4, 8))
    w = rn(120, 3)
    for window, stride in ((30, 10), (10, 10), (60, 60)):
        _fake_vs_real(ops.window_aggregate, w, "max", window, stride)


def test_rule_override_restores_rules():
    before = {k: dict(v) for k, v in shd.PROFILES.items()}
    with HC.rule_override("train", heads=("data", "model"), embed=None):
        assert shd.TRAIN_RULES["heads"] == ("data", "model")
        assert shd.TRAIN_RULES["embed"] == (None,)
        assert shd.PROFILES["train"] is shd.TRAIN_RULES
    assert {k: dict(v) for k, v in shd.PROFILES.items()} == before
    with pytest.raises(RuntimeError):
        with HC.rule_override("serve", mlp="data"):
            assert shd.SERVE_RULES["mlp"] == ("data",)
            raise RuntimeError("variant failed")
    assert {k: dict(v) for k, v in shd.PROFILES.items()} == before


def test_dryrun_main_production_cell(capsys):
    """A 16×16 cell through ``main`` (a fake world of 256 ranks, started
    and destroyed by it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    DR.main(["--arch", "smollm-135m", "--shape", "prefill_32k"])
    out = capsys.readouterr().out
    assert "1 cells ran, 0 failures" in out
    assert "smollm-135m              prefill_32k  16x16" in out
    assert not dist.is_initialized()


def test_make_mesh_is_a_fake_world():
    mesh = HC.make_mesh("2x4")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 8
        assert shd.mesh_shape(mesh) == shd.MeshShape(("data", "model"),
                                                     (2, 4))
    finally:
        dist.destroy_process_group()
