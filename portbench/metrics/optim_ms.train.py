"""optim_ms.train (ms, program span): device ms of the optimizer's update
(``launch.train``'s ``adamw_update``: the global norm, the clip and the
AdamW step over every leaf) in a training step, by CUDA events around the
call, averaged over the traced window's steps."""

SPANS = {"optim": "repro_torch.launch.train:adamw_update"}


def read(run):
    calls = run.spans.get("optim", [])
    if not calls or not run.units:
        return None
    return sum(calls) / run.units
