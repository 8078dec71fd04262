"""ssd_ms.prefill (ms, program span): device ms of the SSD's calls
(``repro_torch.models.ssm.ssd``) in a prefill, by CUDA events around each
call, summed a request and averaged over the traced window's requests."""

SPANS = {"ssd": "repro_torch.models.ssm:ssd"}


def read(run):
    calls = run.spans.get("ssd", [])
    if not calls or not run.units:
        return None
    return sum(calls) / run.units
