"""Logical-axis sharding rules, partition specs and DTensor placements.

The port of the JAX package's ``sharding.py``. Every parameter and cache
leaf carries a tuple of *logical* axis names (one per dim, None = never
sharded). Profiles map logical names to mesh axes:

  train:  FSDP over "data" (embed axis of weights), TP over "model"
          (vocab/heads/mlp/experts/ssm_inner), DP over "pod"+"data" (batch)
  serve:  TP-only weights (no FSDP: decode would all-gather per token),
          batch over pod+data, KV cache per decode rules

The builder is divisibility-aware: a logical axis whose dim does not divide
its mesh axis is dropped (replicated), which is what lets every arch
(9-head smollm, kv=8 GQA on a 16-way model axis, odd vocabs) shard on
every mesh.

The rule functions (``batch_axes_for``, ``spec_for_leaf``,
``kv_cache_spec``, ``ssm_cache_specs``) are pure Python over axis names
and sizes, carried as they are. They take anything with ``axis_names``
and a ``shape`` mapping of name to size: a ``MeshShape``, or a
``DeviceMesh`` through ``mesh_shape``. A spec maps tensor dims to mesh
axes; ``placements_for`` turns it into what DTensor needs, one placement
per mesh dim.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def current_mesh():
    """The ``DeviceMesh`` of the innermost ``use_mesh``, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the framework-level mesh (read by ``moe_fwd``'s expert-parallel
    branch, ``constrain_batch`` and ``act_constraint``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name or a tuple of names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or ranks."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_shape(mesh) -> MeshShape:
    """A ``DeviceMesh`` (or a ``MeshShape``) as a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names for the rules")
    return MeshShape(tuple(names),
                     tuple(mesh.size(i) for i in range(mesh.ndim)))


def _axes(mesh):
    return mesh_shape(mesh) if hasattr(mesh, "mesh_dim_names") else mesh


# ---------------------------------------------------------------------------
# Rule profiles: logical axis -> preferred mesh axes (first that divides wins)
# ---------------------------------------------------------------------------
TRAIN_RULES: Dict[str, Tuple] = {
    "embed": ("data",),            # FSDP / ZeRO-3 shard of the non-TP weight axis
    "vocab": ("model",),
    # input-embedding rows: vocab over model ONLY (no FSDP on the embed dim)
    "vocab_in": ("model",),
    "embed_in": (None,),
    "heads": ("model",),
    "kv_heads": ("model", None),
    "head_dim": (None,),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "layers": (None,),
    "conv": (None,),
}

SERVE_RULES: Dict[str, Tuple] = dict(TRAIN_RULES, embed=(None,))

# batch=1 long-context decode: the data axis carries no batch work, so
# weights spread over it too
SERVE_LONG_RULES: Dict[str, Tuple] = dict(TRAIN_RULES, embed=("data",))

PROFILES = {"train": TRAIN_RULES, "serve": SERVE_RULES,
            "serve_long": SERVE_LONG_RULES}


def batch_axes_for(mesh, batch: int):
    """Largest prefix of data-like axes that divides `batch`."""
    mesh = _axes(mesh)
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    chosen = []
    size = 1
    for a in axes:
        if batch % (size * mesh.shape[a]) == 0:
            chosen.append(a)
            size *= mesh.shape[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    mesh = _axes(mesh)
    if isinstance(name, tuple):
        return int(math.prod(mesh.shape[a] for a in name))
    return mesh.shape[name]


def spec_for_leaf(mesh, logical_axes, shape, rules) -> P:
    """Map one leaf's logical axes to a spec, dropping non-dividers."""
    mesh = _axes(mesh)
    entries = []
    used = set()
    for dim, lax_name in zip(shape, logical_axes):
        choice = None
        if lax_name is not None:
            for cand in rules.get(lax_name, (None,)):
                if cand is None:
                    continue
                if cand in used:
                    continue
                if dim % _axis_size(mesh, cand) == 0:
                    choice = cand
                    break
        if choice is not None:
            used.add(choice)
        entries.append(choice)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def stack_axes(axes, extra: str = "layers"):
    """Prepend the stacked-layers logical axis to every leaf tuple of a
    nested dict (the JAX package's stacked layout; the port's layers are
    one module each and need no such axis)."""
    if isinstance(axes, Mapping):
        return {k: stack_axes(v, extra) for k, v in axes.items()}
    return (extra,) + tuple(axes)


def build_param_specs(mesh, axes: Mapping[str, tuple],
                      shapes: Mapping[str, Sequence[int]],
                      profile: str) -> Dict[str, P]:
    """{name: spec} for ``axes`` ({name: logical axes}, as
    ``model.param_axes`` gives) over ``shapes`` ({name: shape}); every
    name of ``shapes`` must have its axes."""
    rules = PROFILES[profile]
    missing = set(shapes) - set(axes)
    if missing:
        raise KeyError(f"no logical axes for {sorted(missing)}")
    return {k: spec_for_leaf(mesh, axes[k], tuple(s), rules)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------
def placements_for(mesh, spec: Sequence, ndim: int) -> tuple:
    """One DTensor placement per mesh dim for a tensor of ``ndim`` dims
    under ``spec``: ``Shard(d)`` on each mesh dim that tensor dim ``d``'s
    entry names, ``Replicate()`` on the others. An entry that names
    several axes (``("pod", "data")``) shards dim ``d`` over them major to
    minor, as JAX orders them; DTensor shards a dim over mesh dims in the
    mesh's order, so the entry must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh).axis_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} used twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def shardings_from_specs(mesh, specs: Mapping[str, Sequence]):
    """{name: (mesh, placements)} of {name: spec} (the JAX package's
    ``NamedSharding``s); a spec names as many dims as it shards."""
    return {k: (mesh, placements_for(mesh, s, len(s)))
            for k, s in specs.items()}


def build_param_placements(mesh, axes: Mapping[str, tuple],
                           shapes: Mapping[str, Sequence[int]],
                           profile: str) -> Dict[str, tuple]:
    """{name: placements} under ``profile`` (``build_param_specs`` through
    ``placements_for``)."""
    specs = build_param_specs(mesh, axes, shapes, profile)
    return {k: placements_for(mesh, specs[k], len(shapes[k])) for k in specs}


def distribute_model(model: torch.nn.Module, mesh,
                     placements: Optional[Mapping[str, tuple]] = None,
                     dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """Turn every parameter of ``model`` into a DTensor on ``mesh`` (in
    ``dtype`` if given), in place: under ``placements[name]``, or
    replicated where it has none. Each rank keeps its own chunk of what
    it holds, with no scatter: every rank must hold the same parameters
    (drawn from one seed)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    placements = placements or {}
    rep = (Replicate(),) * mesh.ndim
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        dt = distribute_tensor(p.detach().to(dtype or p.dtype), mesh,
                               placements.get(name, rep), src_data_rank=None)
        setattr(mod, leaf, torch.nn.Parameter(dt,
                                              requires_grad=p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# Activation / input / cache specs
# ---------------------------------------------------------------------------
def token_spec(mesh, batch: int) -> P:
    return P(batch_axes_for(mesh, batch), None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


DATA_AXES = ("pod", "data")


def gather_data_axes(w):
    """A DTensor with its splits over the data axes gathered (FSDP's
    all-gather before use), its other placements kept; any other tensor
    as it is."""
    if not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in DATA_AXES and isinstance(p, Shard)
                 else p for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def rows_split(w) -> bool:
    """Whether ``w`` is a DTensor whose first dim is split over a mesh
    axis."""
    if not _is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    return any(p == Shard(0) for p in w.placements)


def act_constraint(x, spec: Sequence):
    """Redistribute a DTensor activation to ``spec`` on the current mesh;
    the identity without a mesh or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    want = placements_for(mesh, spec, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_batch(x, extra=()):
    """Constrain a [B, ...] activation to batch sharding (the identity
    without a mesh or on a plain tensor). `extra` optionally assigns
    trailing dims, e.g. ("model",) for logits."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    b_ax = batch_axes_for(mesh, x.shape[0])
    rest = [None] * (x.ndim - 1 - len(extra)) + list(extra)
    return act_constraint(x, P(b_ax, *rest))


def kv_cache_spec(mesh, batch: int, kv_heads: int, head_dim: int,
                  long_context: bool = False) -> P:
    """Spec for [layers, B, S, KV, dh] caches (decode rules).

    kv_heads → model when divisible; otherwise the sequence dim takes the
    model axis (flash-decoding-style split-KV). batch=1 long-context decode
    additionally spreads the sequence over the data axes.
    """
    mesh = _axes(mesh)
    b_ax = batch_axes_for(mesh, batch)
    m = mesh.shape.get("model", 1)
    if kv_heads % m == 0 and kv_heads >= m:
        kv_ax, seq_ax = "model", None
    else:
        kv_ax, seq_ax = None, "model"
    if b_ax is None:  # batch=1: shard sequence over data too
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        seq_ax = data_axes + ("model",) if seq_ax == "model" else data_axes
        if isinstance(seq_ax, tuple) and len(seq_ax) == 1:
            seq_ax = seq_ax[0]
    return P(None, b_ax, seq_ax, kv_ax, None)


def ssm_cache_specs(mesh, batch: int, n_heads: int) -> Dict[str, P]:
    """Specs for {"conv": [layers,B,K-1,C], "h": [layers,B,H,P,N]}."""
    mesh = _axes(mesh)
    b_ax = batch_axes_for(mesh, batch)
    m = mesh.shape.get("model", 1)
    h_ax = "model" if n_heads % m == 0 else None
    return {"conv": P(None, b_ax, None, "model"),
            "h": P(None, b_ax, h_ax, None, None)}
