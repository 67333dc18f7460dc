"""The benchmark's weights: made from the seed on the run's device, in
float32 (the program's master and served type), in a few large calls:
one normal draw for every parameter, laid out so that the parameters of
one init are contiguous and take one scale. The same seed on the same
device gives the same weights, so the reference makes them again after
the program's run instead of keeping a copy."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

# the order of the inits in the buffer (a group each)
_KIND_ORDER = ("embed", "normal", "ones", "zeros", "a_log", "dt_bias")
DT_RANGE = (1e-3, 1e-1)


def sub_seed(seed: int, *what) -> int:
    """A 63-bit seed for one use of the run's seed (weights, a batch, a
    prompt), so that the uses draw independent streams."""
    h = hashlib.sha256(repr((int(seed),) + what).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device: torch.device, seed: int, *what) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *what))


def make(spec: List[Tuple[str, tuple, tuple]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the reference's ``param_spec``: a normal
    of fan-in ``f`` (and scale ``s``) is s·N(0, 1)/sqrt(f), the embedding
    0.02·N(0, 1), norms ones, biases zeros, ``a_log`` the log of H values
    evenly spaced over [1, 16], ``dt_bias`` softplus⁻¹ of steps drawn
    log-uniformly over ``DT_RANGE``. Every tensor is a view of one
    buffer."""
    def key(item):
        kind = item[2]
        return (_KIND_ORDER.index(kind[0]), tuple(kind[1:]))
    order = sorted(spec, key=key)
    total = sum(math.prod(shape) for _, shape, _ in order)
    buf = torch.randn(total, generator=generator(device, seed, "weights"),
                      device=device, dtype=torch.float32)
    out, at, groups = {}, 0, {}
    for name, shape, kind in order:
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape)
        g = groups.setdefault(kind, [at, at])
        g[1] = at + n
        at += n
    with torch.no_grad():
        for kind, (a, b) in groups.items():
            part = buf[a:b]
            if kind[0] == "embed":
                part.mul_(0.02)
            elif kind[0] == "normal":
                part.mul_((kind[2] if len(kind) > 2 else 1.0)
                          / math.sqrt(kind[1]))
            elif kind[0] == "ones":
                part.fill_(1.0)
            elif kind[0] == "zeros":
                part.zero_()
            elif kind[0] == "dt_bias":
                lo, hi = (math.log(x) for x in DT_RANGE)
                u = torch.rand(b - a, generator=generator(device, seed, "dt"),
                               device=device)
                dt = torch.exp(lo + u * (hi - lo))
                part.copy_(dt + torch.log(-torch.expm1(-dt)))
        for name, shape, kind in order:
            if kind[0] == "a_log":
                out[name].copy_(torch.log(torch.linspace(
                    1.0, 16.0, shape[0], device=device)))
    return out
