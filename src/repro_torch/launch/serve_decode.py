"""Batched LM prefill + greedy decode loop.

``python -m repro_torch.launch.serve_decode --arch mamba2-780m --device cpu``

Port of ``repro.launch.serve_decode`` for every config of the registry:
one prefill, then one decode step per generated token reusing the caches in
place (K/V rings, the SSD's O(1) state, the cross K/V of the VLM's image
patches or of the enc-dec's encoder memory). It runs on ``cuda`` unless
``--device`` says otherwise; as in the reference, ``--reduced`` is on and
cannot be turned off from the command line (``generate`` takes any
config, the full width included). Weights are random, drawn from a seeded
``torch.Generator`` on the device, and so are the stub inputs of the
frontends the reference stubs too: the VLM's memory (B, num_patches,
d_model) and the enc-dec's frames (B, prompt_len, d_model), standard
normals.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as T


def init_params(cfg, generator=None, device=None):
    """``encdec.init_params`` for the enc-dec family, else
    ``transformer.init_params``."""
    return (ED if cfg.family == "encdec" else T).init_params(cfg, generator, device)


def prefill(cfg, params, prompt: torch.Tensor, extras=None, max_len: int | None = None):
    """The family's prefill: the enc-dec encodes ``extras["frames"]``,
    the others take ``extras`` (the VLM's ``"memory"``) as it is."""
    if cfg.family == "encdec":
        return ED.prefill(params, extras["frames"], prompt, cfg, max_len=max_len)
    return T.prefill(params, prompt, cfg, extras, max_len=max_len)


def decode_step(cfg, params, token: torch.Tensor, caches, pos: int, extras=None):
    """The family's decode step (the caches hold everything it reads;
    ``extras["mesh"]``, a ``DeviceMesh``, turns on flash decode for a
    config with ``flash_decode``)."""
    if cfg.family == "encdec":
        return ED.decode_step(params, token, caches, pos, cfg)
    return T.decode_step(params, token, caches, pos, cfg, extras)


def generate(cfg, params, prompt: torch.Tensor, num_tokens: int, extras=None,
             max_len: int | None = None):
    """prompt (B, S) int -> (B, num_tokens) greedy tokens (int32). A
    ``DeviceMesh`` in ``extras["mesh"]`` passes through to the decode
    steps (flash decode, the prefill's caches placed on the mesh first);
    every rank of the mesh must call it with the same inputs."""
    with sh.serving_scope(params):
        return _generate(cfg, params, prompt, num_tokens, extras, max_len)


def _generate(cfg, params, prompt, num_tokens, extras, max_len):
    b, s = prompt.shape
    max_len = max_len or (s + num_tokens)
    logits, caches = prefill(cfg, params, prompt, extras, max_len)
    if cfg.family != "encdec":
        caches = T.shard_decode_caches(cfg, caches, extras)
    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(num_tokens):
        out.append(tok)
        logits, caches = decode_step(cfg, params, tok, caches, s + i, extras)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(out, dim=1)


def stub_extras(cfg, batch: int, prompt_len: int, generator: torch.Generator, device):
    """The stub frontend's output: the VLM's memory (batch, num_patches,
    d_model) or the enc-dec's frames (batch, prompt_len, d_model), standard
    normals from ``generator``; None for the other families."""
    if cfg.family == "vlm":
        return {"memory": torch.randn((batch, cfg.num_patches, cfg.d_model), generator=generator,
                                      device=device)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, prompt_len, cfg.d_model), generator=generator,
                                      device=device)}
    return None


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
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=dev)
    extras = stub_extras(cfg, args.batch, args.prompt_len, gen, dev)

    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, args.tokens, extras).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) sample: {out[0, :12]}")
    assert np.isfinite(out).all()
    return out


if __name__ == "__main__":
    main()
