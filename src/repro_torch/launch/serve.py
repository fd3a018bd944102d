"""Serving launcher CLI: batched prefill + greedy decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --full \\
        --batch 8 --prompt-len 512 --gen 32 --s-max 1024

Without ``--full`` it serves the reduced smoke config in float32.  Weights
and prompts are drawn from seed 0; ``--device cpu`` runs the plain PyTorch
path on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=configs.all_arch_ids())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch) if args.full else configs.smoke_config(args.arch)
    if not cfg.supports_decode():
        raise SystemExit(f"{args.arch} is encoder-only; no decode path")
    cfg = dataclasses.replace(cfg, dtype="float32") if not args.full else cfg
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev).init(gen)
    engine = ServeEngine(model=model, s_max=args.s_max)
    tokens = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=dev
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine.generate({"tokens": tokens}, n_steps=args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{args.arch} on {dev}: generated {out.shape[0]}x{out.shape[1]} tokens in "
          f"{dt:.2f}s ({out.numel() / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
