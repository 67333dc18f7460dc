"""The port's language models against the JAX package's, on the CPU: for
every architecture at ``reduced()``, with the JAX package's weights
(``jax.random.PRNGKey(1)``) carried across by ``lm_params_from_jax``,
the same tokens give the same forward logits, prefill logits and caches,
and one decode step's logits.

On the CPU the port's attention and SSD ops run their plain versions
(exact attention, the sequential recurrence); the JAX package's models
run ``chunked_attention`` and ``ssd_chunked``, the same functions. MoE
capacity is unbounded on both sides, as tests/test_decode_consistency.py
runs it. Tolerances: float32 atol 1e-4 and rtol 1e-4; bfloat16
|err| <= 5e-2 · max|logits| over the real vocabulary.

bfloat16 end to end is held for the architectures without MoE. With MoE
the router's top-k runs on bf16-rounded inputs, where a difference of
one rounding in an earlier layer (the reference rounds attention scores
to bf16, the plain version keeps them in fp32) flips a near-tie between
experts and changes that token's output wholesale: 18–26% of
max|logits| at reduced() with PRNGKey(1). The MoE layer itself is held in
bf16 on the same inputs in tests/test_torch_serve_lm.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RMOE
import repro_torch.models.moe as PMOE
from repro.configs import get_arch, list_archs
from repro.data import make_batch
from repro.models import model as RM
from repro_torch.configs import get_arch as port_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import model as PM

torch.set_num_threads(2)

S, B = 24, 2
ARCHS = list_archs()
BF16_ARCHS = [a for a in ARCHS if get_arch(a).moe is None]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = ([(a, "float32") for a in ARCHS]
         + [(a, "bfloat16") for a in BF16_ARCHS])


@functools.cache
def _setup(name):
    cfg, pcfg = get_arch(name).reduced(), port_arch(name).reduced()
    params = RM.init_params(cfg, jax.random.PRNGKey(1))
    model = lm_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    bd = make_batch(cfg, S + 1, B, step=0)
    bd.pop("labels")
    return cfg, pcfg, params, model, bd


def _tree_np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@functools.cache
def _runs(name, dtype):
    """forward, prefill (logits, caches) and one decode step through both
    packages on the same tokens, as float32 numpy: (ref, port)."""
    cfg, pcfg, params, model, bd = _setup(name)
    jdt, tdt = DTYPES[dtype]
    jb = {k: jnp.asarray(v) for k, v in bd.items()}
    tb = {k: torch.as_tensor(v) for k, v in bd.items()}
    pre_j = {**jb, "tokens": jb["tokens"][:, :S]}
    pre_t = {**tb, "tokens": tb["tokens"][:, :S]}
    saved = RMOE.CAPACITY_FACTOR, PMOE.CAPACITY_FACTOR
    RMOE.CAPACITY_FACTOR = PMOE.CAPACITY_FACTOR = 1000.0
    try:
        f_ref, a_ref = RM.forward(cfg, params, jb, compute_dtype=jdt)
        l0_ref, c_ref = RM.prefill(cfg, params, pre_j, cache_len=S + 8,
                                   compute_dtype=jdt)
        l1_ref, _ = RM.decode_step(cfg, params, c_ref, jb["tokens"][:, S:],
                                   S, compute_dtype=jdt)
        with torch.no_grad():
            f_port, a_port = PM.forward(pcfg, model, tb, compute_dtype=tdt)
        l0_port, c_port = PM.prefill(pcfg, model, pre_t, cache_len=S + 8,
                                     compute_dtype=tdt)
        c_port_np = [{k: v.float().numpy().copy() for k, v in c.items()}
                     for c in c_port]
        l1_port, _ = PM.decode_step(pcfg, model, c_port, tb["tokens"][:, S:],
                                    S, compute_dtype=tdt)
    finally:
        RMOE.CAPACITY_FACTOR, PMOE.CAPACITY_FACTOR = saved
    ref = {"forward": np.asarray(f_ref), "aux": float(a_ref),
           "prefill": np.asarray(l0_ref), "decode": np.asarray(l1_ref),
           "cache": _tree_np(c_ref)}
    port = {"forward": f_port.numpy(), "aux": float(a_port),
            "prefill": l0_port.numpy(), "decode": l1_port.numpy(),
            "cache": c_port_np}
    return ref, port


def _close(got, ref, dtype, vocab=None):
    if vocab is not None:
        got, ref = got[..., :vocab], ref[..., :vocab]
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= 5e-2 * float(np.abs(ref).max()), err


@pytest.mark.parametrize("name,dtype", CASES)
def test_forward_matches_jax(name, dtype):
    ref, port = _runs(name, dtype)
    cfg = get_arch(name).reduced()
    assert port["forward"].shape == (B, S + 1, cfg.padded_vocab)
    _close(port["forward"], ref["forward"], dtype, cfg.vocab_size)
    # padded vocabulary rows are masked alike
    assert np.all(port["forward"][..., cfg.vocab_size:] == -1e30)
    if cfg.moe is not None:
        assert port["aux"] == pytest.approx(ref["aux"], rel=1e-4)


def _unstacked(cfg, ref_cache):
    """The JAX package's caches (one stacked group per pattern position)
    as one dict per layer, in the port's order."""
    groups = ref_cache
    layers = []
    n = cfg.n_layers
    for i in range(n):
        g = groups[i % len(groups)]
        layers.append({k: v[i // len(groups)] for k, v in g.items()})
    return layers


@pytest.mark.parametrize("name,dtype", CASES)
def test_prefill_logits_and_caches_match_jax(name, dtype):
    ref, port = _runs(name, dtype)
    cfg = get_arch(name).reduced()
    assert port["prefill"].shape == (B, cfg.padded_vocab)
    _close(port["prefill"], ref["prefill"], dtype, cfg.vocab_size)
    want = _unstacked(cfg, ref["cache"])
    assert len(port["cache"]) == len(want) == cfg.n_layers
    for got, exp in zip(port["cache"], want):
        assert sorted(got) == sorted(exp)
        for key in exp:
            _close(got[key], exp[key], dtype)


@pytest.mark.parametrize("name,dtype", CASES)
def test_decode_step_matches_jax(name, dtype):
    ref, port = _runs(name, dtype)
    cfg = get_arch(name).reduced()
    assert port["decode"].shape == (B, cfg.padded_vocab)
    _close(port["decode"], ref["decode"], dtype, cfg.vocab_size)


@pytest.mark.parametrize("name", ARCHS)
def test_port_modules_take_every_reference_parameter(name):
    """One module per layer, and the carried tensors equal the JAX tree's
    rows: layer i is row i // P of pattern position i % P."""
    cfg, pcfg, params, model, _ = _setup(name)
    assert len(model.blocks) == cfg.n_layers
    assert [b.kind for b in model.blocks] == (
        ["attn+mlp"] * cfg.n_layers if cfg.enc_dec else cfg.layer_kinds())
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    groups = params["blocks"]
    last = cfg.n_layers - 1
    g = groups[last % len(groups)]
    mixer = "attn" if "attn" in g else "ssm"
    key = "wq" if mixer == "attn" else "w_x"
    got = getattr(getattr(model.blocks[last], mixer), key).detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(g[mixer][key])[
        last // len(groups)])
