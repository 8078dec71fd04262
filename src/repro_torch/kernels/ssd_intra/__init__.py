from repro_torch.kernels.ssd_intra.kernel import ssd_intra_kernel
from repro_torch.kernels.ssd_intra.ops import ssd_intra
from repro_torch.kernels.ssd_intra.ref import ssd_intra_ref

__all__ = ["ssd_intra", "ssd_intra_kernel", "ssd_intra_ref"]
