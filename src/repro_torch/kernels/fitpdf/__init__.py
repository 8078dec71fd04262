from repro_torch.kernels.fitpdf.ops import fit_errors, moments, moments_and_edges
from repro_torch.kernels.fitpdf.ref import fit_errors_ref

__all__ = ["fit_errors", "fit_errors_ref", "moments", "moments_and_edges"]
