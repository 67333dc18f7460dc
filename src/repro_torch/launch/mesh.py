"""Device meshes and the process groups under them.

The port of the JAX package's ``launch/mesh.py``: the meshes are
``torch.distributed`` ``DeviceMesh``es over the default process group,
which the caller starts first:

- ``init_local_world()`` starts a one-rank group on the card (NCCL) or the
  CPU (gloo) from an in-memory store, with no environment variables;
- ``init_fake_world(n)`` starts a fake group of ``n`` ranks in this one
  process, whose collectives move nothing: the dry-run's world, where
  ``FakeTensorMode`` stands in for the tensors;
- a test or a launcher with several processes calls
  ``torch.distributed.init_process_group`` itself.

Building a mesh is a function call, never an import's side effect. A mesh
asked for on the card is a CUDA mesh: without a card it raises, it never
becomes a CPU mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def init_local_world(device_type: str = "cuda") -> None:
    """A one-rank default process group (NCCL on the card, gloo on the
    CPU) from a ``HashStore``."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    if device_type == "cuda":
        dev = resolve_device("cuda")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def init_fake_world(n: int) -> None:
    """A fake default process group of ``n`` ranks (this process is rank
    0): collectives are recorded by the dispatch modes above them and move
    no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    if device_type == "cuda":
        torch.cuda.set_device(resolve_device("cuda"))
    world = dist.get_world_size() if dist.is_initialized() else None
    size = 1
    for s in shape:
        size *= s
    if world != size:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs a "
                           f"process group of {size} ranks, have {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16×16 over ("data", "model"), or 2×16×16 over ("pod", "data",
    "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def submesh_shape(n_chips: int, *, model_parallel: int = 16):
    """(data, model) for ``n_chips``: the model axis as wide as
    ``model_parallel`` allows and ``n_chips`` divides."""
    model = min(model_parallel, n_chips)
    while n_chips % model:
        model //= 2
    return n_chips // model, model


def make_submesh(n_chips: int, *, model_parallel: int = 16,
                 device_type: str = "cuda") -> DeviceMesh:
    """A VDC submesh: n_chips arranged as (data, model)."""
    return _mesh(device_type, submesh_shape(n_chips,
                                            model_parallel=model_parallel),
                 ("data", "model"))


def make_dev_mesh(data: int = 1, model: int = 1,
                  device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the running process group."""
    return _mesh(device_type, (data, model), ("data", "model"))
