"""The gradients of the port's flash attention and SSD ops against the
JAX package's, on the CPU: ``loss.backward()`` through
``repro_torch::flash_attention`` and ``repro_torch::ssd_scan`` against
``jax.grad`` of the plain functions the JAX package trains with,
``models.layers.chunked_attention`` and ``models.ssm.ssd_chunked``, for
the same seeded numpy inputs and output cotangent.

On the CPU the ops' forwards are their plain versions, and their
backwards are the port's only backward (``kernels/*/backward.py``), the
same code that runs on the card. Tolerances: float32 within 1e-5 ·
max|g| of each gradient; bf16 inputs within 5e-2 · max|g| (the two
sides round their bf16 products at different points). One exception,
the SSD's dA in float32: it is one sum over all B·L·P·N terms of each
head, which each package rounds in its own order, so both packages' dA
are held to a float64 gradient (the port's chunked form in float64)
within 1e-5 · max, and to each other within twice that."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention
from repro.models.ssm import ssd_chunked
from repro_torch.configs import get_arch
from repro_torch.data import make_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.backward import ssd_chunked as port_chunked
from repro_torch.kernels.sweeps import (STEP_GRAD_ATOL, STEP_GRAD_RTOL,
                                        STEP_SSM_GRAD_ATOL)
from repro_torch.models import model as M

torch.set_num_threads(2)
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.all(np.isfinite(got)), what
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * float(np.abs(want).max()), (what, err)


# (B, Sq, Skv, H, KV, d, causal)
FLASH_CASES = [(2, 64, 64, 4, 2, 16, True),
               (1, 48, 80, 4, 1, 16, True),      # Sq < Skv, right-aligned
               (2, 64, 64, 2, 2, 64, False),
               (1, 40, 96, 4, 2, 64, False),     # cross-attention shape
               (1, 96, 96, 8, 2, 64, True),
               # Sq > BLOCK_Q: several query blocks, each adding into dK
               # and dV, under a causal key end that moves block by block
               (1, 1100, 1100, 4, 2, 16, True),
               (1, 700, 1300, 2, 1, 16, True),   # Sq < Skv
               (1, 1100, 900, 2, 2, 16, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_CASES)
def test_flash_backward_matches_jax_grad(B, Sq, Skv, H, KV, d, causal,
                                         dtype):
    rng = np.random.default_rng(Sq * 7 + d + causal)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d)))
    do = rng.standard_normal((B, Sq, H, d)).astype(np.float32)
    jdt, tdt = DT[dtype]

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, q_chunk=Sq,
                              q_offset=Skv - Sq)
        return jnp.sum(o.astype(jnp.float32) * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))

    ts = [torch.tensor(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*ts, causal=causal)
    (out.float() * torch.from_numpy(do)).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        assert t.grad.dtype == tdt
        _close(t.grad, w, dtype, f"d{name}")


def test_flash_backward_row_without_keys_is_zero():
    """Causal with Sq > Skv: the first Sq - Skv rows see no key, give 0
    and pass no gradient."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 2, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 24, 1, 16, generator=g, requires_grad=True)
    v = torch.randn(1, 24, 1, 16, generator=g, requires_grad=True)
    out = flash_attention(q, k, v, causal=True)
    out.sum().backward()
    assert torch.all(out[:, :16] == 0)
    assert torch.all(q.grad[:, :16] == 0)
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_op_runs_the_formula_on_the_cpu(dtype, causal):
    """On the CPU the op ``repro_torch::flash_attention_backward`` runs the
    formula (the bf16 kernel is the card's route): bit for bit
    ``flash_attention_backward``, in both types, and autograd through the
    flash op gives the same gradients."""
    from repro_torch.kernels.flash_attention.backward import (
        flash_attention_backward)
    g = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(s, generator=g).to(dt)
                   for s in ((1, 70, 4, 32), (1, 90, 2, 32), (1, 90, 2, 32),
                             (1, 70, 4, 32)))
    got = torch.ops.repro_torch.flash_attention_backward(q, k, v, do, causal)
    want = flash_attention_backward(q, k, v, do, causal)
    for a, b in zip(got, want):
        assert a.dtype == dt and torch.equal(a, b)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*ins, causal=causal).backward(do)
    for t, b in zip(ins, want):
        assert torch.equal(t.grad, b)


# (B, L, H, P, G, N, chunk)
SSD_CASES = [(2, 64, 4, 16, 1, 16, 16),
             (1, 96, 4, 8, 2, 8, 32),
             (2, 40, 2, 16, 1, 16, 16),          # L % chunk: one chunk
             (1, 128, 8, 16, 2, 16, 32)]


def _ssd_inputs(B, L, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CASES)
def test_ssd_backward_matches_jax_grad(B, L, H, P, G, N, chunk, dtype):
    (x, dt, A, Bm, Cm), dy = _ssd_inputs(B, L, H, P, G, N, L + G)
    jdt, tdt = DT[dtype]
    # x, B_ and C in the compute type, dt and A float32, as the model
    # hands them to the scan
    types = (jdt, jnp.float32, jnp.float32, jdt, jdt)

    def f(*args):
        y, _ = ssd_chunked(*args, chunk)
        return jnp.sum(y.astype(jnp.float32) * dy)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a, t) for a, t in zip((x, dt, A, Bm, Cm), types)))

    ttypes = (tdt, torch.float32, torch.float32, tdt, tdt)
    ts = [torch.tensor(a).to(t).requires_grad_(True)
          for a, t in zip((x, dt, A, Bm, Cm), ttypes)]
    y = ssd_scan(*ts, chunk=chunk)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    for name, t, w, tt in zip(("x", "dt", "A", "B_", "C"), ts, want, ttypes):
        assert t.grad.dtype == tt
        if name == "A" and dtype == "float32":
            continue
        _close(t.grad, w, dtype, f"d{name}")
    if dtype == "float32":
        t64 = [torch.tensor(a, dtype=torch.float64).requires_grad_(True)
               for a in (x, dt, A, Bm, Cm)]
        y64, _ = port_chunked(*t64, chunk)
        (y64 * torch.tensor(dy, dtype=torch.float64)).sum().backward()
        _close(ts[2].grad, t64[2].grad.numpy(), "float32", "dA vs float64")
        _close(torch.from_numpy(np.asarray(want[2])), t64[2].grad.numpy(),
               "float32", "the JAX package's dA vs float64")
        got, ref = ts[2].grad.numpy(), np.asarray(want[2])
        assert float(np.abs(got - ref).max()) <= 2 * RTOL["float32"] * float(
            np.abs(ref).max()), "dA vs the JAX package"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CASES[:2])
def test_ssd_backward_op_runs_the_formula_on_the_cpu(B, L, H, P, G, N, chunk,
                                                     dtype):
    """On the CPU the op ``repro_torch::ssd_scan_backward`` runs the
    formula (the bf16 kernel is the card's route): bit for bit
    ``ssd_scan_backward`` and the autograd of ``ssd_chunked`` outside any
    op, each gradient in its input's type; autograd through the SSD op
    gives the same gradients."""
    from repro_torch.kernels.ssd_scan.backward import ssd_scan_backward
    (x, dt, A, Bm, Cm), dy = _ssd_inputs(B, L, H, P, G, N, 2 * L + G)
    tdt = DT[dtype][1]
    ins = [torch.from_numpy(a).to(t) for a, t in zip(
        (x, dt, A, Bm, Cm), (tdt, torch.float32, torch.float32, tdt, tdt))]
    dyt = torch.from_numpy(dy).to(tdt)
    got = torch.ops.repro_torch.ssd_scan_backward(*ins, chunk, dyt)
    want = ssd_scan_backward(*ins, chunk, dyt)
    req = [t.clone().requires_grad_(True) for t in ins]
    plain = torch.autograd.grad(port_chunked(*req, chunk)[0], req, dyt)
    for a, b, c, t in zip(got, want, plain, ins):
        assert a.dtype == t.dtype and torch.equal(a, b)
        assert torch.equal(a, c.to(t.dtype))
    req = [t.clone().requires_grad_(True) for t in ins]
    ssd_scan(*req, chunk=chunk).backward(dyt)
    for t, b in zip(req, want):
        assert torch.equal(t.grad, b)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_backward_on_dtensors_runs_the_op_per_shard(G):
    """On DTensors of a one-rank gloo mesh (batch over "data", heads over
    "model"; B_ and C over "model" with their groups, replicated where
    every head shares one), the SSD op's gradient runs
    ``repro_torch::ssd_scan_backward`` on each shard's local tensors
    (``local_map``) and equals the op's on plain tensors bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import init_local_world, make_dev_mesh
    args, dy = _ssd_inputs(2, 64, 4, 8, G, 8, 13 + G)
    ts = [torch.from_numpy(a) for a in args]
    dyt = torch.from_numpy(dy)
    want = torch.ops.repro_torch.ssd_scan_backward(*ts, 16, dyt)
    init_local_world("cpu")
    try:
        mesh = make_dev_mesh(1, 1, device_type="cpu")
        pl = [Shard(0), Shard(2)]
        bc = [Shard(0), Shard(2) if G > 1 else Replicate()]
        dts = [distribute_tensor(t, mesh, p).requires_grad_(True)
               for t, p in zip(ts, (pl, pl, [Replicate(), Shard(0)], bc,
                                    bc))]
        y = ssd_scan(*dts, chunk=16)
        y.backward(distribute_tensor(dyt, mesh, y.placements))
        for t, w in zip(dts, want):
            assert torch.equal(t.grad.full_tensor(), w)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_CASES)
def test_ssd_chunked_forward_matches_jax(B, L, H, P, G, N, chunk):
    """The backward's torch ``ssd_chunked`` is the JAX package's: y and
    the final state, float32 within 1e-5 · max."""
    args, _ = _ssd_inputs(B, L, H, P, G, N, 3 * L + G)
    wy, wh = jax.jit(ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in args), chunk)
    gy, gh = port_chunked(*(torch.from_numpy(a) for a in args), chunk)
    _close(gy, wy, "float32", "y")
    _close(gh, wh, "float32", "h_final")


def test_ssd_state_op_has_no_state_gradient():
    """``ssd_scan_state``: y differentiates as ``ssd_scan``; a loss on the
    final state raises."""
    args, dy = _ssd_inputs(1, 32, 2, 8, 1, 8, 9)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = ssd_scan(*ts, chunk=16, return_state=True)
    (y * torch.from_numpy(dy)).sum().backward()
    ref = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (ssd_scan(*ref, chunk=16) * torch.from_numpy(dy)).sum().backward()
    for a, b in zip(ts, ref):
        assert torch.equal(a.grad, b.grad)
    y, h = ssd_scan(*ts, chunk=16, return_state=True)
    with pytest.raises(NotImplementedError):
        h.sum().backward()



def _step_grads(cfg, threads):
    """float32 gradients of ``loss_fn`` on the CPU with ``threads``
    threads (the order of its parallel sums)."""
    torch.set_num_threads(threads)
    try:
        model = M.init_params(cfg, torch.Generator().manual_seed(0))
        batch = {k: torch.as_tensor(v) for k, v in
                 make_batch(cfg, 256, 1, 0).items()}
        total, _ = M.loss_fn(cfg, model, batch, compute_dtype=torch.float32,
                             remat="none")
        total.backward()
    finally:
        torch.set_num_threads(2)
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_step_gradients_depend_on_the_order_of_sums(arch):
    """The card-vs-CPU train step's gradient bounds (kernels/sweeps.py)
    against the CPU's own spread: at the arch's width (2 layers,
    vocabulary cut to 1,024, one sequence of 256), float32 gradients taken
    with 1 thread and with 6 (the same sums in other orders) differ by at
    most half of the arch's bound, and in mamba2-1.3b some by more than
    STEP_GRAD_ATOL · max|g|."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=2, vocab_size=1024)
    one, six = _step_grads(cfg, 1), _step_grads(cfg, 6)
    spread = {k: float(((one[k] - six[k]).abs()
                        - STEP_GRAD_RTOL * six[k].abs()).max()
                       / six[k].abs().max()) for k in one}
    atol = STEP_SSM_GRAD_ATOL if cfg.ssm is not None else STEP_GRAD_ATOL
    worst = max(spread, key=spread.get)
    print(f"{arch}: 1 thread vs 6, worst {worst} at {spread[worst]:.3g} · "
          "max|g|")
    assert spread[worst] <= atol / 2, (worst, spread[worst])
    if cfg.ssm is not None:
        assert spread[worst] > STEP_GRAD_ATOL, (worst, spread[worst])
