"""The port's LM serving path on the CPU: the port's own prefill + decode
against its forward for every architecture, greedy generation against the
JAX package's, the MoE layer (routing and capacity drops) and the int8 KV
quantization against the JAX functions, the SSD op's final state against
``ssd_chunked``, the synthetic batches bit for bit, and the serving
launcher at reduced size."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.kvquant as RKV
import repro.models.moe as RMOE
import repro_torch.models.kvquant as PKV
import repro_torch.models.moe as PMOE
from repro.configs import get_arch, list_archs
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data import make_batch as ref_make_batch
from repro.models import model as RM
from repro.models.ssm import ssd_chunked
from repro.train.serve_step import greedy_generate as ref_greedy
from repro_torch.configs import get_arch as port_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.serve import serve_demo
from repro_torch.models import model as PM
from repro_torch.train import greedy_generate, make_decode_step

torch.set_num_threads(2)

ARCHS = list_archs()
MOE_ARCHS = [a for a in ARCHS if get_arch(a).moe is not None]
S, B = 24, 2


@pytest.fixture
def unbounded_capacity(monkeypatch):
    monkeypatch.setattr(RMOE, "CAPACITY_FACTOR", 1000.0)
    monkeypatch.setattr(PMOE, "CAPACITY_FACTOR", 1000.0)


def _port_model(name, seed=1):
    cfg = get_arch(name).reduced()
    params = RM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, lm_params_from_jax(
        port_arch(name).reduced(), jax.tree.map(np.asarray, params),
        device="cpu")


def _torch_batch(bd):
    return {k: torch.as_tensor(v) for k, v in bd.items() if k != "labels"}


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_equals_forward(name, unbounded_capacity):
    """prefill(t[:S]) + decode(t[S]) equals forward(t[:S+1])'s logits at
    S - 1 and S, as tests/test_decode_consistency.py holds the JAX
    package."""
    pcfg = port_arch(name).reduced()
    model = PM.init_params(pcfg, torch.Generator().manual_seed(1))
    tb = _torch_batch(make_batch(pcfg, S + 1, B, step=0))
    with torch.no_grad():
        full, _ = PM.forward(pcfg, model, tb, compute_dtype=torch.float32)
    pre = {**tb, "tokens": tb["tokens"][:, :S]}
    logits0, cache = PM.prefill(pcfg, model, pre, cache_len=S + 8,
                                compute_dtype=torch.float32)
    torch.testing.assert_close(logits0, full[:, S - 1], atol=2e-3,
                               rtol=1e-3)
    logits1, _ = PM.decode_step(pcfg, model, cache, tb["tokens"][:, S:], S,
                                compute_dtype=torch.float32)
    torch.testing.assert_close(logits1, full[:, S], atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_is_the_prefills_layout(name):
    """``init_cache`` gives the caches that prefill writes: the same keys,
    shapes and types, one dict per layer."""
    pcfg = port_arch(name).reduced()
    model = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    tb = _torch_batch(make_batch(pcfg, 12, B, step=0))
    _, filled = PM.prefill(pcfg, model, tb, cache_len=20,
                           compute_dtype=torch.bfloat16)
    empty = PM.init_cache(pcfg, B, 20, torch.bfloat16)
    assert len(empty) == len(filled) == pcfg.n_layers
    for e, f in zip(empty, filled):
        assert {k: (v.shape, v.dtype) for k, v in e.items()} == {
            k: (v.shape, v.dtype) for k, v in f.items()}
        assert all(bool((v == 0).all()) for v in e.values())


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_equal_jax(name, unbounded_capacity):
    cfg, params, model = _port_model(name)
    bd = ref_make_batch(cfg, 16, B, 0, 0)
    bd.pop("labels")
    ref, _ = ref_greedy(cfg, params, {k: jnp.asarray(v)
                                      for k, v in bd.items()},
                        steps=6, cache_len=24, compute_dtype=jnp.float32)
    got, cache = greedy_generate(port_arch(name).reduced(), model,
                                 _torch_batch(bd), steps=6, cache_len=24,
                                 compute_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(cache) == cfg.n_layers


# attention + MoE, Mamba-2, the hybrid of both with a shared expert, and
# whisper's sinusoidal positions and cross-attention caches
DECODE_ARCHS = ["granite-moe-1b-a400m", "mamba2-1.3b", "granite-4.0-h-small",
                "whisper-medium"]


def _prefilled(name, prompt=12, cache_len=24, dtype=torch.bfloat16):
    """A reduced model of ``name``, its caches after a prefill of
    ``prompt`` tokens, and the prefill's pick."""
    cfg = port_arch(name).reduced()
    model = PM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _torch_batch(make_batch(cfg, prompt, B, step=0))
    logits, cache = PM.prefill(cfg, model, batch, cache_len,
                               compute_dtype=dtype)
    return cfg, model, cache, logits.argmax(-1)[:, None]


def _copied(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def _assert_same_caches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_pos_as_a_tensor_equals_an_int(name, unbounded_capacity):
    """``decode_step`` with the write index as a 0-d int64 tensor gives
    the logits and caches of the int, bit for bit, for three steps."""
    cfg, model, cache, tok = _prefilled(name)
    by_int, by_tensor = cache, _copied(cache)
    for pos in range(12, 15):
        want, by_int = PM.decode_step(cfg, model, by_int, tok, pos)
        got, by_tensor = PM.decode_step(cfg, model, by_tensor, tok,
                                        torch.tensor(pos))
        assert torch.equal(got, want), pos
        _assert_same_caches(by_tensor, by_int)
        tok = want.argmax(-1)[:, None]


@pytest.mark.parametrize("name", DECODE_ARCHS)
def test_decode_step_updates_the_caches_it_is_given(name,
                                                    unbounded_capacity):
    """``make_decode_step`` over 8 steps equals ``M.decode_step`` (an int
    write index) and returns the very cache tensors it was given, updated
    in place, the SSM's conv window and state included; each call is
    tallied, on the CPU as op by op."""
    from repro_torch import tracing
    cfg, model, cache, tok = _prefilled(name)
    tensors = [t for c in cache for t in c.values()]
    ref = _copied(cache)
    step = make_decode_step(cfg)
    before = tracing.tallies()
    for pos in range(12, 20):
        logits, cache = step(model, cache, tok, pos)
        want, ref = PM.decode_step(cfg, model, ref, tok, pos)
        assert torch.equal(logits, want), pos
        returned = [t for c in cache for t in c.values()]
        assert len(returned) == len(tensors)
        assert all(a is b for a, b in zip(returned, tensors))
        _assert_same_caches(cache, ref)
        tok = want.argmax(-1)[:, None]
    now = tracing.tallies()
    assert {k: now.get(k, 0) - before.get(k, 0) for k in (
        "serve.graph.eager", "serve.graph.capture", "serve.graph.replay")} \
        == {"serve.graph.eager": 8, "serve.graph.capture": 0,
            "serve.graph.replay": 0}


@pytest.mark.parametrize("name", ARCHS)
def test_make_batch_is_bit_equal(name):
    cfg, pcfg = get_arch(name).reduced(), port_arch(name).reduced()
    for step in (0, 3):
        a = ref_make_batch(cfg, 20, 3, step, seed=5)
        b = make_batch(pcfg, 20, 3, step, seed=5)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ra = RefSyntheticLM(512, 16, seed=2).batch(1, 4)
    rb = SyntheticLM(512, 16, seed=2).batch(1, 4)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])


# ---------------------------------------------------------------- the MoE
def _moe_pair(name, seed=0):
    cfg = get_arch(name).reduced().moe
    p = RMOE.init_moe(jax.random.PRNGKey(seed), 64, cfg)
    m = PMOE.MoE(torch.Generator().manual_seed(0), 64,
                 port_arch(name).reduced().moe)
    with torch.no_grad():
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(m, k).copy_(torch.from_numpy(np.array(p[k])))
    return cfg, p, m


@pytest.mark.parametrize("name", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 1000.0])
def test_moe_layer_matches_jax(name, dtype, capacity_factor, monkeypatch):
    """On the same inputs the MoE layer routes alike and drops the same
    tokens at the same capacity: at the default factor 1.25 some of the
    96 token choices overflow their expert."""
    monkeypatch.setattr(RMOE, "CAPACITY_FACTOR", capacity_factor)
    monkeypatch.setattr(PMOE, "CAPACITY_FACTOR", capacity_factor)
    cfg, p, m = _moe_pair(name)
    x = np.random.default_rng(0).standard_normal((2, 24, 64)).astype(
        np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    yr, ar = RMOE.moe_fwd(p, jnp.asarray(x).astype(jdt), cfg)
    with torch.no_grad():
        yp, ap = PMOE.moe_fwd(m, torch.from_numpy(x).to(tdt))
    assert yp.dtype == tdt and yp.shape == (2, 24, 64)
    ref = np.asarray(yr, np.float32)
    got = yp.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert float(ap) == pytest.approx(float(ar), rel=1e-4)
    T = 48
    if capacity_factor == 1.25:
        assert PMOE._capacity(T, cfg) == RMOE._capacity(T, cfg) < T


# ------------------------------------------------------------ KV quantization
@pytest.mark.parametrize("seed,scale_mag", [(0, 0.01), (1, 1.0), (2, 7.5),
                                            (3, 100.0)])
def test_quant_roundtrip_matches_jax_and_bound(seed, scale_mag):
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed), (4, 64))
                 * scale_mag)
    qr, sr = RKV.quantize_kv(jnp.asarray(x))
    q, s = PKV.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(sr, np.float32))
    err = (PKV.dequantize_kv(q, s, torch.float32) - torch.from_numpy(x))
    assert float(err.abs().max()) <= float(np.abs(x).max()) / 127.0 + 1e-6


def test_attend_quant_matches_jax_and_exact_attention():
    B_, Sl, H, KV, dh = 2, 64, 4, 2, 32
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = np.array(jax.random.normal(ks[0], (B_, 1, H, dh), jnp.float32))
    k_hist = np.array(jax.random.normal(ks[1], (B_, Sl, KV, dh)))
    v_hist = np.array(jax.random.normal(ks[2], (B_, Sl, KV, dh)))
    rc = RKV.init_quant_kv_cache(B_, Sl, KV, dh)
    pc = PKV.init_quant_kv_cache(B_, Sl, KV, dh)
    for t in range(Sl):
        rc = RKV.update_quant_cache(rc, k_hist[:, t:t + 1],
                                    v_hist[:, t:t + 1], t)
        pc = PKV.update_quant_cache(pc, torch.from_numpy(k_hist[:, t:t + 1]),
                                    torch.from_numpy(v_hist[:, t:t + 1]), t)
    for k in rc:
        np.testing.assert_array_equal(pc[k].float().numpy(),
                                      np.asarray(rc[k], np.float32))
    for pos in (Sl - 1, 40):
        ref = np.asarray(RKV.attend_quant(jnp.asarray(q), rc, pos=pos,
                                          dtype=jnp.float32))
        got = PKV.attend_quant(torch.from_numpy(q), pc, pos=pos,
                               dtype=torch.float32).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # against exact attention over the full history
    exact = flash_attention(torch.from_numpy(q), torch.from_numpy(k_hist),
                            torch.from_numpy(v_hist), causal=False).numpy()
    got = PKV.attend_quant(torch.from_numpy(q), pc, pos=Sl - 1,
                           dtype=torch.float32).numpy()
    assert np.abs(got - exact).max() / np.abs(exact).max() < 0.03


def test_quant_cache_bytes_halved():
    qc = PKV.init_quant_kv_cache(8, 1024, 8, 128)
    q_bytes = sum(v.numel() * v.element_size() for v in qc.values())
    assert q_bytes < 0.6 * (2 * 8 * 1024 * 8 * 128 * 2)


# --------------------------------------------------- the SSD's final state
@pytest.mark.parametrize("B_,L,H,P,G,N,chunk", [(2, 64, 4, 16, 1, 16, 32),
                                                (1, 96, 4, 16, 2, 8, 32),
                                                (2, 24, 2, 8, 1, 16, 32)])
def test_ssd_state_variant_matches_ssd_chunked(B_, L, H, P, G, N, chunk):
    """y and h_final of ``ssd_scan(..., return_state=True)`` (the op
    ``repro_torch::ssd_scan_state``) against the JAX package's
    ``ssd_chunked`` within 1e-4 · max|ref|; y equals the op without the
    state."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B_, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B_, L, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B_, L, G, N)) * 0.3).astype(np.float32)
    y_ref, h_ref = ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, h = ssd_scan(*t, chunk=chunk, return_state=True)
    assert h.shape == (B_, H, P, N) and h.dtype == torch.float32
    for got, ref in ((y, y_ref), (h, h_ref)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert torch.equal(y, ssd_scan(*t, chunk=chunk))


def test_attention_at_head_dim_16_takes_the_plain_version_on_the_cpu():
    """reduced() has d_head 16, which the flash kernels take on the card
    (bf16 on the wgmma kernel, float32 on ``flash_d16.cuh``); on the CPU
    the op runs its plain version, chosen by the device."""
    q = torch.randn(1, 8, 4, 16)
    kv = torch.randn(1, 8, 2, 16)
    out = flash_attention(q, kv, kv, causal=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


# ------------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_serve_demo_on_the_cpu(arch, capsys):
    rep = serve_demo(arch, batch=2, prompt_len=16, gen=4, device="cpu")
    cfg = port_arch(arch).reduced()
    assert rep.tokens.shape == (2, 4) and rep.tokens.dtype == np.int32
    assert np.all((rep.tokens >= 0) & (rep.tokens < cfg.vocab_size))
    assert rep.prefill_s > 0 and rep.decode_s > 0
    assert math.isfinite(rep.decode_tokens_per_s)
    assert "tok/s" in capsys.readouterr().out


def test_lm_params_from_jax_takes_every_parameter():
    cfg = get_arch("smollm-135m").reduced()
    params = jax.tree.map(np.asarray, RM.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    params = dict(params)
    params.pop("final_norm")
    with pytest.raises(RuntimeError):
        lm_params_from_jax(port_arch("smollm-135m").reduced(), params,
                           device="cpu")
