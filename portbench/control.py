"""The readings that a cell's limits are set from, other than the
program's own: the control (the reference computed with float8 e4m3
products, the step below the configuration's bfloat16) and, for a
training cell, the faults planted in the reference put in the program's
place (half of each batch's rows left out, the mean taken over the rest;
a state left unchanged reads 1 by construction).

    python3 -m portbench.control --workload <cell> --seeds 11 12 13

runs on the card at the cell's own sizes and prints one JSON line a seed:
{number: reading} for each of ``control`` and the faults. The benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check
from portbench import manifest as M


def prefill_readings(cell: M.Cell, seed: int, device) -> dict:
    idx = list(range(cell.traffic["check"]))
    ref = check.ref_prefill(cell.config, cell.traffic, seed, idx, device)
    low = check.ref_prefill(cell.config, cell.traffic, seed, idx, device, quant="fp8")
    return {"control": {"logit_err": max(check.logit_err(a.cpu(), b.cpu()) for a, b in zip(low, ref))}}


def train_readings(cell: M.Cell, seed: int, device) -> dict:
    ref = check.ref_train(cell.config, cell.traffic, seed, device)
    out = {"control": check.train_numbers(check.ref_train(cell.config, cell.traffic, seed, device,
                                                          quant="fp8"), ref),
           "half_batch": check.train_numbers(check.ref_train(cell.config, cell.traffic, seed, device,
                                                             half=True), ref)}
    still = dict(ref, change_norms={n: 0.0 for n in ref["change_norms"]})  # reads 1 by construction
    out["state_unchanged"] = check.train_numbers(still, ref)
    return out


READINGS = {"prefill": prefill_readings, "train": train_readings}


def readings(cell: M.Cell, seed: int, device) -> dict:
    return READINGS[cell.traffic["kind"]](cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = M.Cell(M.load(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                          **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
