"""Serving launcher: batched prefill and greedy decode with KV/state
caches, on the card unless ``device="cpu"``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --full --batch 4 --prompt-len 4096 --gen 32

At full width the weights are the port's own seeded initialization,
made on the device; without ``--full`` the architecture's ``reduced()``
configuration runs.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data import make_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.train.serve_step import greedy_generate


@dataclasses.dataclass
class ServeReport:
    """What one ``serve_demo`` run generated and how long it took (host
    clock after a device sync)."""
    arch: str
    tokens: np.ndarray          # [batch, gen] int32
    prefill_s: float
    decode_s: float             # all gen decode steps
    batch: int
    prompt_len: int
    gen: int

    @property
    def decode_ms_per_token(self) -> float:
        return self.decode_s / self.gen * 1e3

    @property
    def prefill_tokens_per_s(self) -> float:
        return self.batch * self.prompt_len / self.prefill_s

    @property
    def decode_tokens_per_s(self) -> float:
        return self.batch * self.gen / self.decode_s


def serve_demo(arch: str, *, batch: int = 4, prompt_len: int = 64,
               gen: int = 32, full: bool = False, seed: int = 0,
               device: DeviceLike = None) -> ServeReport:
    """One greedy generation in bf16: ``batch`` prompts of ``prompt_len``
    synthetic tokens, ``gen`` tokens out; prints and returns the times."""
    dev = resolve_device(device)
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    bd = make_batch(cfg, prompt_len, batch, 0, seed)
    bd.pop("labels", None)
    bd = {k: torch.as_tensor(v, device=dev) for k, v in bd.items()}

    timings = {}
    toks, _ = greedy_generate(cfg, model, bd, steps=gen,
                              cache_len=prompt_len + gen, timings=timings)
    toks = toks.cpu().numpy()
    rep = ServeReport(arch, toks, timings["prefill_s"], timings["decode_s"],
                      batch, prompt_len, gen)
    print(f"{arch}: generated {toks.shape} on {dev}; prefill "
          f"{rep.prefill_s * 1e3:.1f} ms ({rep.prefill_tokens_per_s:.0f} "
          f"tok/s), decode {rep.decode_ms_per_token:.2f} ms/token "
          f"({rep.decode_tokens_per_s:.1f} tok/s)")
    assert np.all((toks >= 0) & (toks < cfg.padded_vocab))
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    serve_demo(args.arch, batch=args.batch, prompt_len=args.prompt_len,
               gen=args.gen, full=args.full, device=args.device)


if __name__ == "__main__":
    main()
