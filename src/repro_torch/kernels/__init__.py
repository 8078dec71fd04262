"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
beside the plain PyTorch version of the same function."""


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process, by kernel name
    (CUDA launches only: a wrapper given CPU tensors counts nothing)."""
    from repro_torch.kernels.band_attn.kernel import banded_attention_kernel
    from repro_torch.kernels.fitpdf.kernel import fit_error_counts, moments_edges_stats
    from repro_torch.kernels.hist.kernel import hist_counts
    from repro_torch.kernels.moments.kernel import moments_stats

    return {"moments_edges_stats": moments_edges_stats.launches,
            "fit_error_counts": fit_error_counts.launches,
            "fit_error_counts_row_indices": fit_error_counts.row_index_launches,
            "moments_stats": moments_stats.launches,
            "hist_counts": hist_counts.launches,
            "banded_attention_kernel": banded_attention_kernel.launches}
