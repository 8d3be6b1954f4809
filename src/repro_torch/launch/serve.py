"""Batched serving CLI on one device: prefill + greedy decode loop (port of
``repro.launch.serve`` without the mesh).

Runs the reduced architecture (vocab 512) from random weights made from
``--seed``, through ``Model.prefill`` and ``Model.decode``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` (with no GPU and no --device it
exits with an error).  Every architecture of the zoo runs: dense, MoE
(with MLA), SSM, hybrid, audio and vlm.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.fl.engine import resolve_device
from repro_torch.models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-7b", choices=arch_names())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; required to run "
                         "without a GPU, e.g. --device cpu)")
    args = ap.parse_args(argv)

    cfg = replace(get_config(args.arch, reduced=True), vocab_size=512)
    try:
        device = resolve_device(args.device)
        model = Model(cfg, device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen)
    print(f"{cfg.name}: {model.param_count(params):,} params on {device}")

    rng = np.random.default_rng(args.seed)
    B, K = args.batch, args.prompt_len
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, K)),
                              device=device)
    prefix = None
    if cfg.frontend:
        prefix = torch.as_tensor(rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)), dtype=torch.float32,
            device=device)

    P = cfg.frontend_len if cfg.frontend else 0
    cache_len = P + K + args.new_tokens
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, prefix, max_len=cache_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [torch.argmax(logits, -1)]
    t0 = time.perf_counter()
    for i in range(args.new_tokens - 1):
        logits, cache = model.decode(params, cache, out[-1], P + K + i)
        out.append(torch.argmax(logits, -1))
    _sync(device)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(out, dim=1).cpu().numpy()
    print(f"prefill: {B}x{K} tokens in {t_prefill * 1e3:.1f} ms")
    print(f"decode:  {args.new_tokens - 1} steps x {B} seqs in "
          f"{t_decode * 1e3:.1f} ms "
          f"({(args.new_tokens - 1) * B / max(t_decode, 1e-9):.0f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {toks[b].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
