"""The paper's technique applied to the LM substrate, through the PyTorch
port: uncertainty quantification of an *ensemble* of model outputs.

The counterpart of ``examples/uq_ensemble.py``. Each "point" is one logit
coordinate; each "observation" is that logit under one ensemble member
(different init seeds: a stand-in for checkpoint ensembles or MC-dropout
in production). The same core engine (moments -> grouping -> fit -> Eq.-5
error) that processes the seismic cube processes the logit tensor; on the
card the moments are the moments kernel's (K3). See DESIGN.md §5
(Arch-applicability).

  PYTHONPATH=src python examples/uq_ensemble_torch.py --device cpu

Without ``--device`` it runs on the CUDA device (and raises when there is
none), as the port's entry points do.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import distributions as d
from repro_torch.core import fitting
from repro_torch.core.grouping import group_host
from repro_torch.core.pipeline import resolve_device
from repro_torch.kernels.moments.ops import moments
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = registry.get("granite-3-8b").reduced()
    ensemble = 64
    toks = torch.randint(0, cfg.vocab, (1, 16), generator=torch.Generator().manual_seed(9)).to(dev)

    # ensemble of logits at the last position: (points=vocab, obs=ensemble)
    outs = []
    for seed in range(ensemble):
        p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        outs.append(T.forward(p, toks, cfg)[0, -1])
    obs = torch.stack(outs, dim=1).float().contiguous()  # (vocab, ensemble)
    print(f"ensemble logit matrix: {tuple(obs.shape)} on {dev}")

    m = moments(obs)
    keys = np.stack(
        [np.round(m.mean.cpu().numpy() / 1e-3), np.round(m.std.cpu().numpy() / 1e-3)], 1
    ).astype(np.int64)
    g = group_host(keys)
    print(f"grouping: {g.num_groups} groups for {len(keys)} logits "
          f"({len(keys) / g.num_groups:.1f}x dedup)")

    r = fitting.compute_pdf_and_error(obs, m, d.TYPES_4, 16)
    pct = np.bincount(r.type_idx.cpu().numpy(), minlength=4) / obs.shape[0]
    print("logit distribution types across the vocab:")
    for t, p_ in zip(d.TYPES_4, pct):
        print(f"  {t:12s} {p_:6.1%}")
    print(f"avg Eq.-5 error: {float(r.error.mean()):.4f}")
    # the classic CLT sanity check: sums of many random features -> normal
    assert pct[0] > 0.5, "ensemble logits should be predominantly normal"
    print("OK: ensemble logits are predominantly normal (CLT), "
          "with per-coordinate PDFs + errors available for UQ.")
    return pct


if __name__ == "__main__":
    main()
