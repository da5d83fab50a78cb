"""Serving launcher: batched greedy decoding over the slot engine, on the
CUDA card (``--device cpu`` runs the plain PyTorch path on the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --requests 8 --max-new 16

``--arch`` is any ported architecture: qwen2-7b, qwen1.5-4b (dense),
mamba2-370m (ssm) or zamba2-1.2b (hybrid).
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir to load params from (not ported "
                         "yet: comes with the checkpoint slice)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.checkpoint:
        ap.error("--checkpoint is not ported yet: restoring a checkpoint "
                 "comes with the checkpoint slice")

    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_params(cfg, 0, device=device)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(2, 12))).astype(np.int32),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    for i, r in enumerate(done):
        print(f"req{i:02d} ({len(r.prompt)} prompt toks) -> {r.out}")
    print(f"{len(done)} requests, {total} tokens, {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {device.type})")


if __name__ == "__main__":
    main()
