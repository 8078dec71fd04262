"""prefill_p90_ms (ms, host clock): the 90th percentile of the latency of
every prefill of the window, each from its issue to its logits
synchronised on the host."""

import statistics


def read(run):
    if run.units < 2:
        return None
    return statistics.quantiles(run.latencies_s, n=10, method="inclusive")[8] * 1e3
