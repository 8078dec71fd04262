"""Train a reduced LM config end to end with the PyTorch port (the loss goes
down), checkpoint it, resume it, and check that the resumed run ends on the
uninterrupted run's bits. Any of the 10 registry archs works via --arch.

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-780m --steps 60

The counterpart of ``examples/train_lm.py``: ``repro_torch.launch.train``
runs ``--steps`` steps with a checkpoint halfway (async) and at the end;
the end's checkpoint is then removed and the run resumed from the halfway
one to the same end (the same cosine schedule, the token pipeline's cursor
restored), and its final checkpoint must be bitwise the removed one; then,
as the reference's example does, 10 more steps from there.
"""

import argparse
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.pipeline import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train


def _leaves(path: Path) -> tuple[dict, list]:
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "leaves.npz")
    return manifest, [data[f"l{i}"] for i in range(manifest["num_leaves"])]


def first_loss(arch: str, batch: int, seq: int, device) -> float:
    """The loss of the seed-0 model on the pipeline's first batch (what
    step 0 starts from)."""
    cfg = registry.get(arch).reduced()
    model = train.init_model(cfg, device)
    tokens, targets = TokenPipeline(cfg.vocab, seq, batch).next_batch()
    with torch.no_grad():
        return float(train.loss_of(model, train.make_batch(cfg, tokens, targets, 0, device), cfg))


def run(arch: str, steps: int, batch: int, seq: int, device, ckpt: Path) -> dict:
    """The flow above in ``ckpt``; returns its numbers and raises if the
    resumed run's final state is not the uninterrupted one's bits."""
    common = ["--arch", arch, "--reduced", "--batch", str(batch), "--seq", str(seq), "--lr", "1e-3",
              "--ckpt-dir", str(ckpt), "--device", str(device)]
    half = max(steps // 2, 1)
    loss = train.main(common + ["--steps", str(steps), "--ckpt-every", str(half)])
    end = ckpt / f"step_{steps:08d}"
    straight = _leaves(end)
    shutil.rmtree(end)
    resumed_loss = train.main(common + ["--steps", str(steps), "--resume"])
    resumed = _leaves(end)
    same = straight[0] == resumed[0] and all(
        a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(straight[1], resumed[1]))
    if not same or resumed_loss != loss:
        raise AssertionError(f"the run resumed from step {half} does not end on the uninterrupted "
                             f"run's bits (final loss {resumed_loss} vs {loss})")
    more = train.main(common + ["--steps", str(steps + 10), "--resume"])
    return dict(first_loss=first_loss(arch, batch, seq, device), final_loss=loss, resumed_from=half,
                resumed_bitwise=same, leaves=len(straight[1]), loss_after_10_more=more)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        nums = run(args.arch, args.steps, args.batch, args.seq, resolve_device(args.device), Path(ckpt))
    print(f"loss {nums['first_loss']:.4f} -> {nums['final_loss']:.4f} after {args.steps} steps; resumed "
          f"from step {nums['resumed_from']}: bitwise the uninterrupted run; 10 more steps: loss "
          f"{nums['loss_after_10_more']:.4f}")


if __name__ == "__main__":
    main()
