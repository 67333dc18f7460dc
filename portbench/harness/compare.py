"""The comparison that decides ``correct``: what the program produced on
the timed path against the plain reference (``portbench/reference``),
which makes its own weights and inputs from the seed.

Training: the first three steps' losses, each leaf's gradient norm as
the optimizer got it in step 1, and each leaf's change after step 3.
Serving: for each sampled request, the widest gap by which a served
token's logit lies below the reference's best at that position.
The controls (``CONTROLS``) are the reference in the program's place in
the precision below the configuration's bf16, fp8 in either format: a
cell's limits have to fail both.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.reference import common as R

FIRST_STEPS = 3
CONTROLS = ("fp8_e4m3", "fp8_e5m2")
SKETCH = 4          # random projections of each leaf's gradient
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone, and is left out of the change
STILL_LEAF = 1e-3


def family(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def names(cfg: dict) -> List[str]:
    return [n for n, _, _ in family(cfg).param_spec(cfg)]


def reference_train(cfg: dict, traffic: dict, seed: int,
                    device: torch.device, precision: str = "fp32") -> dict:
    """The first steps of the reference from the seed's weights and
    batches: {"loss": [3], "grad": [leaves] float64 (step 1, clipped),
    "change": [leaves] float64 (after step 3)}."""
    R.exact_fp32()
    fam, order = family(cfg), names(cfg)
    params = W.make(fam.param_spec(cfg), seed, device)
    for p in params.values():
        p.requires_grad_(True)
    o = traffic["optimizer"]
    opt, mm = R.AdamW(params, o), R.Products(precision)
    losses, grad = [], None
    for i in range(FIRST_STEPS):
        batch = T.train_batch(traffic, cfg, seed, i, device)
        h, aux = fam.hidden(cfg, params, batch["tokens"], mm)
        ce = R.cross_entropy(R.logits(cfg, params, h, mm), batch["labels"])
        (ce + aux).backward()
        grads = R.clip_by_global_norm({n: params[n].grad for n in order},
                                      o["clip_norm"])
        if i == 0:
            grad = R.leaf_norms(grads, order).cpu()
            sk = sketch(grads, order, seed, device)
        opt.step(params, grads, R.learning_rate(i, o))
        for p in params.values():
            p.grad = None
        losses.append(float(ce.detach()))
        del h, aux, ce, grads
    return {"loss": losses, "grad": grad, "sketch": sk,
            "change": change_norms(cfg, params, seed, device)}


@torch.no_grad()
def sketch(grads: Dict[str, torch.Tensor], order: List[str], seed: int,
           device: torch.device) -> torch.Tensor:
    """SKETCH projections of each leaf's gradient on random directions
    drawn from the seed (the same on both sides), [leaves, SKETCH]
    float64 on the host: enough to estimate the relative error of the
    whole gradient without keeping the program's copy of it."""
    out = []
    for i, n in enumerate(order):
        g = grads[n].reshape(-1).float()
        r = torch.randn(SKETCH, g.numel(), device=device,
                        generator=W.generator(device, seed, "sketch", i))
        out.append((r * g).sum(-1).double())
        del r
    return torch.stack(out).cpu()


@torch.no_grad()
def change_norms(cfg: dict, params: Dict[str, torch.Tensor], seed: int,
                 device: torch.device) -> torch.Tensor:
    """Each leaf's norm of (now - the seed's weights), float64, on the
    host."""
    start = W.make(family(cfg).param_spec(cfg), seed, device)
    out = torch.stack([(params[n].detach().double() - start[n].double())
                       .norm() for n in names(cfg)]).cpu()
    del start
    return out


def train_readings(got: dict, ref: dict) -> dict:
    """The gaps of the program's first steps from the reference's, each
    taken at the worst step or leaf: a loss's relative gap; a leaf's gap
    of norms over the larger of that leaf's and the median leaf's
    reference norm (the gradient at step 1; the change after step 3,
    leaving out leaves the reference does not move). And ``grad_error``,
    the relative error of step 1's whole gradient, ||g - g_ref|| /
    ||g_ref||, from the sketches: a norm of a leaf barely moves with
    rounding spread over its elements, the error of the vector does."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g, rg = got["grad"].double(), ref["grad"].double()
    med = float(rg.median())
    grad = float(((g - rg).abs() / rg.clamp(min=med)).max())
    moved = rg >= STILL_LEAF * med
    c, rc = got["change"].double()[moved], ref["change"].double()[moved]
    medc = float(rc.median())
    change = float(((c - rc).abs() / rc.clamp(min=medc)).max())
    err = float((got["sketch"] - ref["sketch"]).norm() / ref["sketch"].norm())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_error": err}


def worst_leaves(got: dict, ref: dict, order: List[str], n: int = 5):
    """The leaves that carry most of ``grad_error``: [name, share of the
    squared error]."""
    e = (got["sketch"] - ref["sketch"]).square().sum(-1)
    top = e.argsort(descending=True)[:n].tolist()
    return [[order[i], float(e[i] / e.sum())] for i in top]


@torch.no_grad()
def reference_logit_gaps(cfg: dict, traffic: dict, seed: int,
                         device: torch.device, served: Sequence[tuple],
                         controls: Sequence[str] = ()) -> dict:
    """For each served request (``(Request, tokens [batch, n] int)``):
    the reference's float32 logits at every position that produced a
    served token (the prompt, then each token fed back). -> {"logit_gap":
    the widest gap below the reference's best of a served token,
    "logit_gap_mean": the mean of those gaps over every served token,
    "tokens": tokens compared}; with ``controls`` (precisions of
    ``reference.common.Products``) also "control": {precision: the same
    two numbers of the token that the reference in that precision puts
    first at each of those positions}."""
    R.exact_fp32()
    fam = family(cfg)
    params = W.make(fam.param_spec(cfg), seed, device)
    products = [R.Products(p) for p in ("fp32", *controls)]
    widest, total, n = 0.0, 0.0, 0
    ctl = {p: {"logit_gap": 0.0, "total": 0.0} for p in controls}
    for req, out in served:
        out = torch.as_tensor(np.asarray(out), device=device).long()
        p = T.prompt(traffic, cfg, seed, req, device)
        L, k = p.shape[1], out.shape[1]
        seq = torch.cat([p, out[:, :-1]], dim=1)
        groups = list(range(L, L + k - 1))     # one decode call each
        ref, *low = (R.logits(cfg, params, fam.hidden(cfg, params, seq, mm,
                                                      groups)[0][:, L - 1:],
                              mm) for mm in products)
        best = ref.max(-1).values
        gap = best - ref.gather(-1, out[..., None])[..., 0]
        widest = max(widest, float(gap.max()))
        total += float(gap.double().sum())
        for p, lg in zip(controls, low):
            cgap = best - ref.gather(-1, lg.argmax(-1, keepdim=True))[..., 0]
            ctl[p]["logit_gap"] = max(ctl[p]["logit_gap"], float(cgap.max()))
            ctl[p]["total"] += float(cgap.double().sum())
        n += out.numel()
        del ref, low
    out = {"logit_gap": widest, "logit_gap_mean": total / n, "tokens": n}
    if controls:
        out["control"] = {p: {"logit_gap": c["logit_gap"],
                              "logit_gap_mean": c["total"] / n}
                          for p, c in ctl.items()}
    return out


def check(readings: dict, limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number with a limit."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())

