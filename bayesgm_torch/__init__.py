"""bayesgm_torch — the PyTorch/CUDA port of :mod:`bayesgm_tpu`.

Module names follow the JAX package one for one, so each part of the port
sits beside the function it is held against.  The port imports ``torch`` and
never ``jax`` nor anything of the JAX package.

Top-level symbols are resolved lazily, as in ``bayesgm_tpu/__init__.py``, so
importing the package stays cheap.
"""

__version__ = "0.1.0"

_SYMBOL_TO_MODULE = {
    "BGM": "bayesgm_torch.models.bgm",
    "MNISTBGM": "bayesgm_torch.models.mnist",
    "CausalBGM": "bayesgm_torch.models.causalbgm",
    "IdentifiableCausalBGM": "bayesgm_torch.models.identifiable",
    "FullMCMCCausalBGM": "bayesgm_torch.models.fullmcmc",
    "EnsembleCausalBGM": "bayesgm_torch.models.ensemble",
    "Semi_acic_sampler": "bayesgm_torch.datasets.causal_samplers",
    "Semi_Twins_sampler": "bayesgm_torch.datasets.causal_samplers",
    "Sim_Hirano_Imbens_sampler": "bayesgm_torch.datasets.causal_samplers",
    "Sim_Sun_sampler": "bayesgm_torch.datasets.causal_samplers",
    "Sim_Colangelo_sampler": "bayesgm_torch.datasets.causal_samplers",
    "Base_sampler": "bayesgm_torch.datasets.base_sampler",
    "Gaussian_sampler": "bayesgm_torch.datasets.prior_samplers",
    "GMM_indep_sampler": "bayesgm_torch.datasets.prior_samplers",
    "Swiss_roll_sampler": "bayesgm_torch.datasets.prior_samplers",
    "simulate_regression": "bayesgm_torch.datasets.simulators",
    "simulate_low_rank_data": "bayesgm_torch.datasets.simulators",
    "simulate_heteroskedastic_data": "bayesgm_torch.datasets.simulators",
    "simulate_z_hetero": "bayesgm_torch.datasets.simulators",
    "get_ADRF": "bayesgm_torch.utils.helpers",
    "estimate_latent_dims": "bayesgm_torch.utils.helpers",
    "mnist_mask_indices": "bayesgm_torch.utils.helpers",
    "make_ellipse_images": "bayesgm_torch.datasets.images",
    "load_mnist_images": "bayesgm_torch.datasets.images",
    "parse_file": "bayesgm_torch.utils.data_io",
    "parse_file_triplet": "bayesgm_torch.utils.data_io",
    "save_data": "bayesgm_torch.utils.data_io",
}

__all__ = sorted(_SYMBOL_TO_MODULE) + ["__version__"]


def __getattr__(name):
    module_path = _SYMBOL_TO_MODULE.get(name)
    if module_path is None:
        raise AttributeError(f"module 'bayesgm_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module_path), name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return __all__
