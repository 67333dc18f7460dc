"""The port's distributed paths on the CPU, with gloo ranks in child
processes, against the single-device port and the JAX package:

* GPipe ``pipeline_forward`` on 2 (and 4) ranks equals the sequential
  stack within 1e-5 (tests/test_pp.py's sizes), with the stage
  parameters whole on every rank or DTensors split over "pod";
* int8 and top-k compression equal the JAX package's bit for bit, and
  ``compressed_allreduce`` on 2 ranks equals the mean of the JAX
  package's per-rank compressed values, its residuals the JAX package's;
  error feedback keeps the mean transmitted gradient near the true one
  (tests/test_runtime.py's test);
* the MoE's expert-parallel branch on a 1×2 mesh equals the
  single-device ``moe_fwd`` within 1e-5 in fp32, gradients included, and
  the JAX package's; on a 2×2 mesh each data shard equals the
  single-device layer on its tokens, and the gradients their sum; on a
  1×3 mesh, whose "model" axis does not divide the experts, the layer
  runs whole on every rank and equals the single-device one;
* ``train_loop(mesh=)`` with data=2 (and model=2, and ``gather_once``
  with two microbatches) on a reduced config equals the mesh-less losses
  within 1e-5;
* the loader's per-rank slices equal ``make_batch``'s rows;
* ``train_loop(mesh=, ckpt_dir=)`` through injected failures restores
  the same checkpoints on every rank as the mesh-less loop;
* elastic restore: a checkpoint written from a 2×4 mesh, and one written
  by the JAX package, restored onto 8×1 give the saved values exactly
  (tests/test_checkpoint.py:74-106).

Every child process has its own gloo group from a TCP store on
localhost and destroys it; each test joins its children within
``JOIN_S`` seconds and fails (killing them) past it, so a hung rank
fails its test instead of the suite.
"""
import os
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as RC

from repro_torch.runtime import compression as PC

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120

PRELUDE = """
import datetime, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
torch.set_num_threads(1)
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out = sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=90))
try:
{body}
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(body: str, world: int, out: Path) -> Path:
    """Run ``body`` on ``world`` gloo ranks (child processes), each with
    ``rank``, ``world``, ``out`` and a started process group; all must
    exit 0 within JOIN_S seconds."""
    out.mkdir(parents=True, exist_ok=True)
    script = out / "worker.py"
    script.write_text(PRELUDE.format(
        src=str(ROOT / "src"), body=textwrap.indent(textwrap.dedent(body),
                                                    "    ")))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(world), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=str(ROOT))
             for r in range(world)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append((p.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, rc, err[-3000:]) for r, (rc, _, err) in enumerate(logs) if rc]
    assert not bad, bad
    return out


# ------------------------------------------------------------------ GPipe
@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 6)])
def test_pipeline_matches_sequential(tmp_path, n_stages, n_micro):
    _run(f"""
    from repro_torch.runtime.pp import pipeline_forward
    mesh = init_device_mesh("cpu", ({n_stages},), mesh_dim_names=("pod",))
    n_stages, n_micro, mb, d = {n_stages}, {n_micro}, 3, 16
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((n_stages, d, d))
                         .astype(np.float32) * 0.3)
    x = torch.from_numpy(rng.standard_normal((n_micro, mb, d))
                         .astype(np.float32))

    def stage_fn(p, h):
        return torch.tanh(h @ p)

    pp = pipeline_forward(stage_fn, n_stages, n_micro, mesh)
    y = pp(w, x)
    y_split = pp(distribute_tensor(w, mesh, [Shard(0)]), x)
    ref = x
    for s in range(n_stages):
        ref = torch.tanh(ref @ w[s])
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(y, y_split)
    np.save(f"{{out}}/y{{rank}}.npy", y.numpy())
    """, n_stages, tmp_path)
    # every rank returns the same outputs, and they are the JAX
    # sequential stack's
    ys = [np.load(tmp_path / f"y{r}.npy") for r in range(n_stages)]
    for y in ys[1:]:
        np.testing.assert_array_equal(y, ys[0])
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n_stages, 16, 16)).astype(np.float32) * 0.3
    x = rng.standard_normal((n_micro, 3, 16)).astype(np.float32)
    ref = jnp.asarray(x)
    for s in range(n_stages):
        ref = jnp.tanh(ref @ w[s])
    np.testing.assert_allclose(ys[0], np.asarray(ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ compression
CASES = [((64,), 10.0, 0), ((4, 33), 1.0, 1), ((1000,), 1e-3, 2),
         ((8, 8, 8), 250.0, 3), ((7,), 0.5, 4)]


@pytest.mark.parametrize("shape,scale,seed", CASES)
def test_compression_bit_identical(shape, scale, seed):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    rq, rs = RC.compress_int8(jnp.asarray(x))
    pq, ps = PC.compress_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.numpy().tobytes() == np.asarray(rs).tobytes()
    assert (PC.decompress_int8(pq, ps).numpy().tobytes()
            == np.asarray(RC.decompress_int8(rq, rs)).tobytes())
    for frac in (0.05, 0.25, 1.0):
        np.testing.assert_array_equal(
            PC.topk_compress(torch.from_numpy(x), frac).numpy(),
            np.asarray(RC.topk_compress(jnp.asarray(x), frac)))


def _ref_sent(g, r, scheme, frac):
    """The JAX package's compressed value of one rank (its ``one``)."""
    gf = jnp.asarray(g, jnp.float32) + jnp.asarray(r)
    if scheme == "int8":
        sent = RC.decompress_int8(*RC.compress_int8(gf))
    elif scheme == "topk":
        sent = RC.topk_compress(gf, frac)
    elif scheme == "int8+topk":
        sent = RC.decompress_int8(*RC.compress_int8(
            RC.topk_compress(gf, frac)))
    else:
        sent = gf
    return np.asarray(sent), np.asarray(gf - sent)


SCHEMES = ("int8", "topk", "int8+topk", "none")


def test_compressed_allreduce_two_ranks(tmp_path):
    _run(f"""
    from repro_torch.runtime.compression import (ErrorFeedbackState,
                                                 compressed_allreduce)
    rng = np.random.default_rng(rank)
    grads = {{"a": torch.from_numpy(rng.standard_normal(32)
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal((4, 8))
                                   .astype(np.float32) * 3)}}
    res = {{}}
    for scheme in {SCHEMES!r}:
        ef = ErrorFeedbackState.init(grads)
        for it in range(2):
            mean, ef = compressed_allreduce(grads, ef, scheme=scheme,
                                            topk_frac=0.25)
            for k in grads:
                res[f"{{scheme}}/{{it}}/mean/{{k}}"] = mean[k].numpy()
                res[f"{{scheme}}/{{it}}/res/{{k}}"] = ef.residual[k].numpy()
    np.savez(f"{{out}}/r{{rank}}.npz", **res)

    # error feedback: the mean transmitted gradient tracks the true one
    # (tests/test_runtime.py), the same gradient on both ranks
    g_true = {{"g": torch.from_numpy(np.random.default_rng(9)
                                    .standard_normal(32).astype(np.float32))}}
    ef = ErrorFeedbackState.init(g_true)
    sent = torch.zeros(32)
    for _ in range(20):
        m, ef = compressed_allreduce(g_true, ef, scheme="int8+topk",
                                     topk_frac=0.25)
        sent = sent + m["g"]
    err = float((sent / 20 - g_true["g"]).abs().mean())
    assert err < 0.15 * float(g_true["g"].abs().mean()), err
    """, 2, tmp_path)
    got = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    grads = []
    for r in range(2):
        rng = np.random.default_rng(r)
        grads.append({"a": rng.standard_normal(32).astype(np.float32),
                      "b": rng.standard_normal((4, 8)).astype(np.float32)
                      * 3})
    for scheme in SCHEMES:
        resid = [{k: np.zeros(v.shape, np.float32) for k, v in g.items()}
                 for g in grads]
        for it in range(2):
            for k in ("a", "b"):
                sent = []
                for r in range(2):
                    s, resid[r][k] = _ref_sent(grads[r][k], resid[r][k],
                                               scheme, 0.25)
                    sent.append(s)
                want = (sent[0] + sent[1]) / np.float32(2)
                for r in range(2):
                    np.testing.assert_array_equal(
                        got[r][f"{scheme}/{it}/mean/{k}"], want)
                    np.testing.assert_array_equal(
                        got[r][f"{scheme}/{it}/res/{k}"], resid[r][k])


# -------------------------------------------------------------------- MoE
MOE_BODY = """
from repro_torch import sharding as shd
from repro_torch.configs import get_arch
from repro_torch.models import moe as MOE
data, model = {data}, {model}
cfg = get_arch("olmoe-1b-7b").reduced().moe
d = 64
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((4, 8, d)).astype(np.float32))
cot = torch.from_numpy(rng.standard_normal((4, 8, d)).astype(np.float32))


def layer():
    return MOE.MoE(torch.Generator().manual_seed(0), d, cfg{share})


def loss(y, aux, c):
    return (y * c).sum() + 3.0 * aux


mesh = init_device_mesh("cpu", (data, model),
                        mesh_dim_names=("data", "model"))
# each data shard's tokens through the single-device layer
rows = 4 // data
shard = mesh.get_coordinate()[0]
sl = slice(shard * rows, (shard + 1) * rows)
one = layer()
y0, a0 = MOE.moe_fwd(one, x[sl])
loss(y0, a0 / data, cot[sl]).backward()

ep = shd.distribute_model(layer(), mesh)
pl = shd.placements_for(mesh, shd.P("data"), 3)
xd = distribute_tensor(x, mesh, pl, src_data_rank=None)
with shd.use_mesh(mesh):
    y1, a1 = MOE.moe_fwd(ep, xd)
loss(y1, a1, distribute_tensor(cot, mesh, pl,
                               src_data_rank=None)).backward()
yl = y1.redistribute(mesh, pl).to_local()
np.testing.assert_allclose(yl.detach().numpy(), y0.detach().numpy(),
                           atol=1e-5, rtol=1e-5)
# aux: each data shard's, averaged over the data shards
a_all = [torch.zeros(1) for _ in range(world)]
dist.all_gather(a_all, a0.detach().reshape(1))
a_mean = sum(a_all[i * model] for i in range(data)) / data
np.testing.assert_allclose(float(a1.full_tensor()), float(a_mean[0]),
                           atol=1e-6, rtol=1e-5)
# the gradients: the data shards' single-device gradients summed
for name, p in one.named_parameters():
    g = p.grad.clone()
    dist.all_reduce(g)
    g = g / model        # every model rank holds the same shard's
    got = dict(ep.named_parameters())[name].grad.full_tensor()
    np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-5,
                               rtol=1e-5, err_msg=name)
np.savez(f"{{out}}/r{{rank}}.npz", y=y1.full_tensor().detach().numpy(),
         **{{k: v.detach().numpy() for k, v in one.named_parameters()}})
"""


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 3)])
def test_moe_expert_parallel(tmp_path, data, model):
    """(1, 3): a "model" axis that does not divide the 4 experts, where
    every rank routes all tokens through all experts (the JAX package
    leaves that case to its partitioner)."""
    _run(MOE_BODY.format(data=data, model=model, share=""), data * model,
         tmp_path)
    if data != 1:
        return
    # one data shard: the JAX package's single-device layer on the same
    # weights and tokens
    from repro.configs import get_arch as ref_arch
    from repro.models import moe as RMOE
    got = np.load(tmp_path / "r0.npz")
    cfg = ref_arch("olmoe-1b-7b").reduced().moe
    params = {k: jnp.asarray(got[k]) for k in
              ("router", "w_gate", "w_up", "w_down")}
    x = np.random.default_rng(0).standard_normal((4, 8, 64)).astype(
        np.float32)
    y_ref, _ = RMOE.moe_fwd(params, jnp.asarray(x), cfg)
    np.testing.assert_allclose(got["y"], np.asarray(y_ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2), (1, 3)])
def test_moe_share_expert_parallel(tmp_path, data, model):
    """A layer holding 4 of the 16 experts its router scores, with a
    shared expert: split over "model" (or, at 3, every rank through all
    4), each data shard's output and the gradients equal the
    single-device layer's, the shared expert counted once."""
    _run(MOE_BODY.format(data=data, model=model,
                         share=", routed=16, shared_ff=48"),
         data * model, tmp_path)


# ------------------------------------------------------------- train_loop
def _hp(accum=1, gather_once=False):
    from repro_torch.train import TrainHParams
    return TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=4,
                        remat="full", compute_dtype=torch.float32,
                        grad_accum=accum, gather_once=gather_once)


@pytest.mark.parametrize("data,model,accum,gather_once",
                         [(2, 1, 1, False), (1, 2, 1, False),
                          (2, 1, 2, True)])
def test_train_loop_on_a_mesh_equals_meshless(tmp_path, data, model, accum,
                                              gather_once):
    _run(f"""
    from repro_torch.launch.train import train_loop
    from repro_torch.train import TrainHParams
    mesh = init_device_mesh("cpu", ({data}, {model}),
                            mesh_dim_names=("data", "model"))
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=4,
                      remat="full", compute_dtype=torch.float32,
                      grad_accum={accum}, gather_once={gather_once})
    _, losses = train_loop("smollm-135m", steps=3, batch=4, seq=32,
                           device="cpu", hp=hp, mesh=mesh, log_every=100)
    np.save(f"{{out}}/l{{rank}}.npy", np.asarray(losses))
    """, data * model, tmp_path)
    from repro_torch.launch.train import train_loop
    _, want = train_loop("smollm-135m", steps=3, batch=4, seq=32,
                         device="cpu", hp=_hp(accum), log_every=100)
    for r in range(data * model):
        np.testing.assert_allclose(np.load(tmp_path / f"l{r}.npy"), want,
                                   atol=1e-5, rtol=1e-5)


def test_train_loop_restarts_on_a_mesh_like_meshless(tmp_path):
    """train_loop(mesh=, ckpt_dir=) on 2 ranks through injected failures
    (seed 0, p_fail 0.3: steps 1, 3 and 4 fail once each, and checkpoints
    are written at steps 0, 2 and 4): every rank replays the same steps
    from the same checkpoints as the mesh-less loop, with its losses."""
    _run("""
    from repro_torch.launch.train import train_loop
    from repro_torch.train import TrainHParams
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=5,
                      remat="full", compute_dtype=torch.float32)
    steps = []
    _, losses = train_loop("smollm-135m", steps=5, batch=4, seq=32,
                           device="cpu", hp=hp, mesh=mesh, log_every=100,
                           ckpt_dir=f"{out}/ck", save_every=2, p_fail=0.3,
                           on_step=lambda step, rec: steps.append(step))
    np.save(f"{out}/s{rank}.npy", np.asarray(steps))
    np.save(f"{out}/l{rank}.npy", np.asarray(losses))
    """, 2, tmp_path)
    from repro_torch.launch.train import train_loop
    from repro_torch.train import TrainHParams
    hp = TrainHParams(peak_lr=1e-3, warmup_steps=2, total_steps=5,
                      remat="full", compute_dtype=torch.float32)
    steps = []
    _, want = train_loop("smollm-135m", steps=5, batch=4, seq=32,
                         device="cpu", hp=hp, log_every=100,
                         ckpt_dir=str(tmp_path / "ref"), save_every=2,
                         p_fail=0.3,
                         on_step=lambda step, rec: steps.append(step))
    assert steps == [0, 0, 1, 2, 2, 3, 4]
    for r in range(2):
        assert np.load(tmp_path / f"s{r}.npy").tolist() == steps
        np.testing.assert_allclose(np.load(tmp_path / f"l{r}.npy"), want,
                                   atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- loader
def test_loader_slices_equal_make_batch(tmp_path):
    _run("""
    from repro_torch.configs import get_arch
    from repro_torch.data import ShardedLoader, make_batch
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_arch("internvl2-76b").reduced()
    loader = ShardedLoader(cfg, 16, 8, mesh=mesh, seed=5, device="cpu")
    host = make_batch(cfg, 16, 8, 3, 5)
    got = loader(3)
    assert set(got) == set(host)
    d = mesh.get_coordinate()[0]
    for k, v in got.items():
        assert v.placements == (Shard(0), Replicate())
        np.testing.assert_array_equal(v.to_local().numpy(),
                                      host[k][d * 4:(d + 1) * 4])
        np.testing.assert_array_equal(v.full_tensor().numpy(), host[k])
    full = {k: v.full_tensor().numpy() for k, v in got.items()}
    if rank == 0:
        np.savez(f"{out}/batch.npz", **full)
    """, 4, tmp_path)
    from repro.configs import get_arch as ref_arch
    from repro.data.tokens import make_batch as ref_make_batch
    want = ref_make_batch(ref_arch("internvl2-76b").reduced(), 16, 8, 3, 5)
    got = np.load(tmp_path / "batch.npz")
    assert set(got.files) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# -------------------------------------------------------- elastic restore
def test_elastic_restore_across_meshes(tmp_path):
    """A checkpoint written from a 2×4 mesh, and one written by the JAX
    package, restored onto an 8×1 mesh: each rank holds its rows, the
    whole equals what was saved."""
    from repro.checkpoint import save_checkpoint as ref_save
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    ref_save(str(tmp_path / "jax"), 7, {"w": jnp.asarray(w),
                                        "b": jnp.arange(8.0) * 0.5})
    _run("""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    w = torch.arange(64.0).reshape(8, 8)
    mesh1 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    mesh2 = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data", "model"))
    sharded = distribute_tensor(w, mesh1, [Shard(0), Shard(1)])
    save_checkpoint(f"{out}/port", 1, {"w": sharded})
    sh = {"w": (mesh2, [Shard(0), Replicate()])}
    restored, step = restore_checkpoint(f"{out}/port",
                                        {"w": torch.zeros(8, 8)},
                                        shardings=sh)
    assert step == 1
    assert restored["w"].placements == (Shard(0), Replicate())
    assert torch.equal(restored["w"].to_local(), w[rank:rank + 1])
    assert torch.equal(restored["w"].full_tensor(), w)
    # into a DTensor template, in place
    tmpl = {"w": distribute_tensor(torch.zeros(8, 8), mesh2,
                                   [Shard(0), Replicate()])}
    back, _ = restore_checkpoint(f"{out}/port", tmpl)
    assert back["w"] is tmpl["w"] and torch.equal(back["w"].full_tensor(), w)
    # the JAX package's checkpoint
    sh = {"w": (mesh2, [Shard(1), Replicate()]), "b": None}
    got, step = restore_checkpoint(f"{out}/jax", {"w": torch.zeros(8, 8),
                                                  "b": torch.zeros(8)},
                                   shardings=sh)
    assert step == 7
    assert torch.equal(got["w"].full_tensor(), w)
    assert torch.equal(got["w"].to_local(), w[:, rank:rank + 1])
    assert torch.equal(got["b"], torch.arange(8.0) * 0.5)
    """, 8, tmp_path)
