"""Batched LM prefill + greedy decode loop.

``python -m repro_torch.launch.serve_decode --arch gemma3-12b --device cpu``

Port of ``repro.launch.serve_decode``: one prefill, then one decode step
per generated token reusing the caches in place. It runs on ``cuda``
unless ``--device`` says otherwise; as in the reference, ``--reduced`` is
on and cannot be turned off from the command line (``generate`` takes any
config, the full width included). Weights are random, drawn from a seeded
``torch.Generator`` on the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import transformer as T


@torch.inference_mode()
def generate(cfg, params, prompt: torch.Tensor, num_tokens: int, max_len: int | None = None):
    """prompt (B, S) int -> (B, num_tokens) greedy tokens (int32)."""
    b, s = prompt.shape
    max_len = max_len or (s + num_tokens)
    logits, caches = T.prefill(params, prompt, cfg, max_len=max_len)
    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(num_tokens):
        out.append(tok)
        logits, caches = T.decode_step(params, tok, caches, s + i, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=dev)

    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, args.tokens).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) sample: {out[0, :12]}")
    assert np.isfinite(out).all()
    return out


if __name__ == "__main__":
    main()
