from repro_torch.kernels.moments.kernel import NUM_STATS, moments_stats, moments_stats_plain
from repro_torch.kernels.moments.ops import moments

__all__ = ["NUM_STATS", "moments", "moments_stats", "moments_stats_plain"]
