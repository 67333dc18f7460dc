"""DTensor sharding rules for the port's custom ops.

A rule lists, for one mesh dim, the placements under which the op may run
on local shards and give the shard of the whole result:
``torch.distributed.tensor.experimental.register_sharding`` expands the
list to every combination over the mesh's dims. Some combinations are
wrong for a shape (GQA heads split across two mesh dims whose product
does not divide the kv heads), so each op also has a check of a whole
combination against the inputs' shapes; combinations that fail it are
never offered. An op without a rule raises under DTensor: it is never
run gathered in its place.

The check takes a private hook of torch: ``register`` wraps the op's
entry in DTensor's strategy table,
``DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs``, when
an op's module is imported, so it acts in every DTensor run of these ops,
not only the dry-run. It touches the port's own ops' entries and no
other. ``strategy_table`` raises if a torch version has moved the table
(tests/test_torch_sharding.py checks that it is there).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import register_sharding


def shard_count(spec, dim: int) -> int:
    """How many pieces ``spec``'s placements cut tensor dim ``dim`` into."""
    return math.prod(spec.mesh.size(i) for i, p in enumerate(spec.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def register(ops: Sequence, rule: Callable,
             valid: Callable[[Sequence, Sequence], bool]) -> None:
    """Register ``rule`` for each op of ``ops`` and keep, of the
    combinations it expands to, those that pass ``valid(input_specs,
    args)``: each spec carries its mesh, placements and global shape;
    ``args`` are the op's arguments, its non-tensor ones as given."""
    register_sharding(list(ops))(rule)
    funcs = strategy_table()
    for op in ops:
        expand = funcs[op]

        def checked(op_schema, expand=expand):
            strategy = expand(op_schema)
            strategy.strategies = [s for s in strategy.strategies
                                   if valid(s.input_specs,
                                            op_schema.args_schema)]
            return strategy
        checked.valid = valid
        funcs[op] = checked


def strategy_table() -> dict:
    """DTensor's private {op: strategy function} table, which ``register``
    wraps; a RuntimeError if this torch has none where it is looked for."""
    prop = getattr(getattr(DTensor, "_op_dispatcher", None),
                   "sharding_propagator", None)
    funcs = getattr(prop, "op_strategy_funcs", None)
    if not isinstance(funcs, dict):
        raise RuntimeError(
            "torch's DTensor has no "
            "_op_dispatcher.sharding_propagator.op_strategy_funcs table: "
            "the port's sharding rules cannot check their combinations")
    return funcs
