"""Input and result files and the statistical helpers (the export list of
``bayesgm_tpu/utils/__init__.py``; numpy and scipy only)."""

from bayesgm_torch.utils.data_io import parse_file, parse_file_triplet, save_data
from bayesgm_torch.utils.helpers import (
    estimate_latent_dims,
    get_ADRF,
    get_SDR_dim,
    mnist_mask_indices,
    slice_y,
)

__all__ = [
    "save_data",
    "parse_file",
    "parse_file_triplet",
    "get_ADRF",
    "slice_y",
    "get_SDR_dim",
    "estimate_latent_dims",
    "mnist_mask_indices",
]
