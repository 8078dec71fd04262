"""The one general generator of traffic: it reads a mix's parameters
(``portbench/traffic/<mix>.json``) and makes its inputs from ``--seed``.

Every unit of work (a request, a training step) has its own index and its
own stream of the seed, so the same seed gives the same inputs whatever
ran before, and every seed gives the same sizes: only the token values
move with the seed. Index -1, -2, ... are the warm-up's, 0, 1, ... the
measured ones (a training cell's checked steps are its first indices).

Parameters read:

* ``kind``: ``prefill`` (closed loop of prefills) or ``train`` (steps
  back to back);
* ``batch``, ``seq_len``: the shape of a request or a step;
* ``tokens``: ``uniform`` (ids uniform over the configuration's
  vocabulary, the only law today);
* ``prefill``: ``cache_extra`` (decode positions each cache is sized
  for beyond the prompt), ``warmup`` (requests in set-up), ``check``
  (requests the reference checks);
* ``train``: the optimizer's settings, ``checked_steps`` (the steps the
  reference follows, run in set-up).
"""

from __future__ import annotations

import torch

from portbench.weights import generator


def _tokens(traffic: dict, vocab: int, seed: int, stream: str, length: int, device) -> torch.Tensor:
    if traffic["tokens"] != "uniform":
        raise ValueError(f"token law {traffic['tokens']!r} is not generated")
    gen = generator(seed, stream, device)
    return torch.randint(0, vocab, (traffic["batch"], length), generator=gen, device=device)


def prompt(traffic: dict, config: dict, seed: int, index: int, device) -> torch.Tensor:
    """Request ``index``'s prompt: (batch, seq_len) int64 token ids."""
    return _tokens(traffic, config["vocab"], seed, f"prompt/{index}", traffic["seq_len"], device)


def train_batch(traffic: dict, config: dict, seed: int, index: int, device) -> dict:
    """Step ``index``'s rows: ``tokens`` and their next-token ``targets``,
    each (batch, seq_len) int64, cut from one draw of seq_len + 1 ids."""
    ids = _tokens(traffic, config["vocab"], seed, f"train/{index}", traffic["seq_len"] + 1, device)
    return {"tokens": ids[:, :-1].contiguous(), "targets": ids[:, 1:].contiguous()}


def tokens_per_unit(traffic: dict) -> int:
    return traffic["batch"] * traffic["seq_len"]
