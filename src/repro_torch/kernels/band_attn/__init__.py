from repro_torch.kernels.band_attn.kernel import banded_attention_kernel
from repro_torch.kernels.band_attn.ops import banded_attention
from repro_torch.kernels.band_attn.ref import banded_attention_ref

__all__ = ["banded_attention", "banded_attention_kernel", "banded_attention_ref"]
