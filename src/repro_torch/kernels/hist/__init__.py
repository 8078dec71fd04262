from repro_torch.kernels.hist.kernel import hist_counts, hist_counts_plain
from repro_torch.kernels.hist.ops import histogram

__all__ = ["hist_counts", "hist_counts_plain", "histogram"]
