"""Port of ``repro.optim``: AdamW, Adafactor, the cosine schedule and int8
compression, over ``{name: tensor}`` mappings, updating in place."""

from repro_torch.optim.adafactor import FactoredState, adafactor_init, adafactor_update
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import compress_int8, decompress_int8, pod_allreduce_compressed
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "OptState", "global_norm",
    "FactoredState", "adafactor_init", "adafactor_update",
    "cosine_schedule", "compress_int8", "decompress_int8", "pod_allreduce_compressed",
]
