"""The port's sharding rules against the JAX package's, on the CPU.

The rule functions are carried as they are, so every spec must be equal:

* ``spec_for_leaf`` of every parameter of all ten architectures at full
  width, under the three profiles, on 16×16, 2×16×16, 1×4, 2×2 and 4×1
  meshes. The reference's side runs on ``jax.sharding.AbstractMesh``
  (no devices), the port's on its ``MeshShape``; the reference's layers
  are stacked with a leading "layers" axis that no profile shards, and
  its spec's first entry is dropped for the port's per-layer names;
* ``param_axes`` equal to the reference's through ``convert``'s naming
  (layer r·P + j of the port is row r of the reference's group j);
* ``batch_axes_for``, ``kv_cache_spec``, ``ssm_cache_specs`` and the
  cache specs of ``launch/specs.py`` (the reference's with its layers
  entry dropped);
* ``placements_for``: a spec's mesh axes as DTensor placements;
* the flash attention op's sharding rule never offers q's heads split
  with k/v's kv heads whole, nor a heads split that cuts a GQA group.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as RS
from repro.configs import list_archs
from repro.configs import get_arch as ref_arch
from repro.launch import specs as RSP
from repro.models import model as RM

from repro_torch import sharding as PS
from repro_torch.configs import get_arch
from repro_torch.launch import specs as PSP
from repro_torch.models import model as PM

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
PROFILES = ("train", "serve", "serve_long")
ARCHS = list_archs()


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), PS.MeshShape(names, sizes)


def _entries(spec):
    return tuple(spec)


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


def _ref_by_port_name(cfg, tree):
    """The reference's {path: leaf} under the port's parameter names:
    blocks[j]…[r] → blocks.{r·P + j}…, enc_blocks likewise."""
    out = {}
    _flat({k: v for k, v in tree.items()
           if k not in ("blocks", "enc_blocks")}, "", out)
    for key, n in (("blocks", cfg.n_layers),
                   ("enc_blocks", cfg.enc_dec.n_enc_layers
                    if cfg.enc_dec is not None else 0)):
        if key not in tree:
            continue
        groups = tree[key]
        R = n // len(groups)
        for j, group in enumerate(groups):
            flat = {}
            _flat(group, "", flat)
            for path, leaf in flat.items():
                for r in range(R):
                    out[f"{key}.{r * len(groups) + j}.{path}"] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """{port name: (reference axes with "layers", reference shape)}."""
    cfg = ref_arch(arch)
    axes = _ref_by_port_name(cfg, RM.param_axes(cfg))
    shapes = _ref_by_port_name(cfg, jax.eval_shape(
        lambda: RM.init_params(cfg, jax.random.PRNGKey(0))))
    return {name: (ax, tuple(shapes[name].shape))
            for name, ax in axes.items()}


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return {k: tuple(v.shape)
            for k, v in PSP.param_sds(get_arch(arch)).items()}


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_leaf_equals_reference(arch, profile):
    ref, port = _ref_leaves(arch), _port_shapes(arch)
    axes = PM.param_axes(get_arch(arch))
    assert set(ref) == set(port) == set(axes)
    for mesh_name in MESHES:
        rmesh, pmesh = _meshes(mesh_name)
        for name, (rax, rshape) in ref.items():
            stacked = name.startswith(("blocks.", "enc_blocks."))
            want = _entries(RS.spec_for_leaf(rmesh, rax, rshape,
                                             RS.PROFILES[profile]))
            if stacked:
                assert rax[0] == "layers" and (not want or want[0] is None)
                want = want[1:]
            got = _entries(PS.spec_for_leaf(pmesh, axes[name], port[name],
                                            PS.PROFILES[profile]))
            assert got == want, (mesh_name, name)
        specs = PS.build_param_specs(pmesh, axes, port, profile)
        assert specs == {k: PS.spec_for_leaf(pmesh, axes[k], port[k],
                                             PS.PROFILES[profile])
                         for k in port}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    """The port's axes are the reference's without the "layers" axis;
    each has one entry per dim of the port's parameter."""
    ref, port = _ref_leaves(arch), _port_shapes(arch)
    axes = PM.param_axes(get_arch(arch))
    for name, (rax, rshape) in ref.items():
        stacked = name.startswith(("blocks.", "enc_blocks."))
        assert tuple(axes[name]) == (tuple(rax[1:]) if stacked
                                     else tuple(rax)), name
        assert len(axes[name]) == len(port[name])
        assert port[name] == (rshape[1:] if stacked else rshape), name


def test_stack_axes_equal_reference():
    tree = {"a": ("embed", None), "b": {"c": ("heads",)}}
    assert PS.stack_axes(tree) == RS.stack_axes(tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_reference(mesh_name):
    rmesh, pmesh = _meshes(mesh_name)
    for batch in (1, 2, 4, 8, 16, 32, 128, 256, 512):
        assert PS.batch_axes_for(pmesh, batch) == RS.batch_axes_for(
            rmesh, batch)
        assert PS.token_spec(pmesh, batch) == tuple(RS.token_spec(
            rmesh, batch))
        for kv in (1, 2, 4, 8, 16, 32):
            for long_ctx in (False, True):
                assert tuple(PS.kv_cache_spec(pmesh, batch, kv, 128,
                                              long_ctx)) == tuple(
                    RS.kv_cache_spec(rmesh, batch, kv, 128, long_ctx))
        for heads in (8, 24, 32, 48, 64):
            r = RS.ssm_cache_specs(rmesh, batch, heads)
            p = PS.ssm_cache_specs(pmesh, batch, heads)
            assert {k: tuple(v) for k, v in p.items()} == {
                k: tuple(v) for k, v in r.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_cache_specs_equal_reference(arch):
    """specs.cache_specs per layer == the reference's cache_shardings (on
    an AbstractMesh) of the layer's group, without the leading layers
    entry."""
    cfg = ref_arch(arch)
    pattern, _ = cfg.scan_groups()
    for mesh_name in ("16x16", "2x16x16", "2x2"):
        rmesh, pmesh = _meshes(mesh_name)
        for batch, long_ctx in ((128, False), (1, True), (2, False)):
            ref = [{k: v.spec for k, v in d.items()} for d in
                   RSP.cache_shardings(rmesh, cfg, batch, long_ctx)]
            port = PSP.cache_specs(pmesh, get_arch(arch), batch, long_ctx)
            assert len(port) == cfg.n_layers
            for i, layer in enumerate(port):
                want = ref[0] if cfg.enc_dec is not None else ref[
                    i % len(pattern)]
                assert {k: tuple(v) for k, v in layer.items()} == {
                    k: tuple(v)[1:] for k, v in want.items()}, (i, mesh_name)


def test_placements_for():
    from torch.distributed.tensor import Replicate, Shard
    mesh = PS.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert PS.placements_for(mesh, PS.P(("pod", "data"), None, "model"),
                             3) == (Shard(0), Shard(0), Shard(2))
    assert PS.placements_for(mesh, PS.P(), 2) == (Replicate(),) * 3
    assert PS.placements_for(mesh, PS.P(None, "data"), 2) == (
        Replicate(), Shard(1), Replicate())
    assert PS.shardings_from_specs(mesh, {"w": PS.P(None, "model")}) == {
        "w": (mesh, (Replicate(), Replicate(), Shard(1)))}
    with pytest.raises(ValueError):
        PS.placements_for(mesh, PS.P(("data", "pod")), 1)
    with pytest.raises(ValueError):
        PS.placements_for(mesh, PS.P("data", "data"), 2)


class _Spec:
    """What a sharding check reads of a DTensorSpec."""

    def __init__(self, shape, placements, sizes):
        self.shape, self.placements = shape, tuple(placements)
        self.mesh = type("M", (), {"size": lambda _, i: sizes[i]})()


def test_flash_rule_never_splits_q_heads_alone():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.flash_attention import ops
    for rule in (ops.flash_sharding, ops.flash_backward_sharding):
        args = (None,) * (5 if rule is ops.flash_backward_sharding else 4)
        for out, ins in rule(*args):
            q, k, v = ins[:3]
            assert not (q == Shard(2) and k == Replicate()), (out, ins)
            assert q == k == v and all(o == q for o in out)
    # a combination over two mesh dims whose heads split cuts the kv heads
    # unevenly (GQA groups across ranks) is refused
    sizes = (2, 4)
    ok = _Spec((2, 64, 16, 128), (Shard(0), Shard(2)), sizes)
    okk = _Spec((2, 64, 8, 128), (Shard(0), Shard(2)), sizes)
    assert ops._flash_valid([ok, okk, okk], None)
    both = _Spec((2, 64, 16, 128), (Shard(2), Shard(2)), sizes)
    bothk = _Spec((2, 64, 4, 128), (Shard(2), Shard(2)), sizes)
    assert not ops._flash_valid([both, bothk, bothk], None)
    rep = _Spec((2, 64, 8, 128), (Shard(0), Replicate()), sizes)
    assert not ops._flash_valid([ok, rep, rep], None)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recompute_runs_under_the_callers_mesh(remat):
    """A rematerialized layer's recompute sees the mesh of its forward
    even when the backward runs in another thread, as autograd's device
    thread does on the card (the MoE's expert-parallel branch, the batch
    constraints and the train step read the mesh from ``use_mesh``)."""
    import threading
    seen = []

    def layer(x):
        seen.append(PS.current_mesh())
        return (x @ x.T).sin()
    mesh = object()
    x = torch.randn(4, 4, requires_grad=True)
    with PS.use_mesh(mesh):
        y = PM._remat(layer, remat)(x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [mesh, mesh] and x.grad is not None


def test_rules_are_in_torchs_strategy_table():
    """The combination checks wrap entries of DTensor's private strategy
    table: a torch that moves or renames it fails here, not mid-run."""
    from repro_torch.kernels import sharding_rules
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.window_agg import ops as wops
    funcs = sharding_rules.strategy_table()
    for op, valid in (
            (torch.ops.repro_torch.flash_attention.default, fops._flash_valid),
            (torch.ops.repro_torch.flash_attention_backward.default,
             fops._flash_valid),
            (torch.ops.repro_torch.ssd_scan.default, sops._ssd_valid),
            (torch.ops.repro_torch.ssd_scan_state.default, sops._ssd_valid),
            (torch.ops.repro_torch.window_aggregate.default,
             wops._window_valid)):
        assert getattr(funcs[op], "valid", None) is valid, op


def test_ssd_rule_splits_groups_with_heads():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.ssd_scan import ops
    sizes = (2, 4)
    h = (Replicate(), Shard(2))
    x = _Spec((2, 64, 16, 64), h, sizes)
    dt = _Spec((2, 64, 16), h, sizes)
    A = _Spec((16,), (Replicate(), Shard(0)), sizes)
    one = _Spec((2, 64, 1, 128), (Replicate(), Replicate()), sizes)
    assert ops._ssd_valid([x, dt, A, one, one], None)
    four = _Spec((2, 64, 4, 128), h, sizes)
    assert ops._ssd_valid([x, dt, A, four, four], None)
    four_rep = _Spec((2, 64, 4, 128), (Replicate(), Replicate()), sizes)
    assert not ops._ssd_valid([x, dt, A, four_rep, four_rep], None)
    one_split = _Spec((2, 64, 1, 128), h, sizes)
    assert not ops._ssd_valid([x, dt, A, one_split, one_split], None)
