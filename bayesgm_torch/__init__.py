"""bayesgm_torch — the PyTorch/CUDA port of :mod:`bayesgm_tpu`.

Module names follow the JAX package one for one, so each part of the port
sits beside the function it is held against.  The port imports ``torch`` and
never ``jax`` nor anything of the JAX package.

Top-level symbols are resolved lazily, as in ``bayesgm_tpu/__init__.py``, so
importing the package stays cheap.
"""

__version__ = "0.1.0"

_SYMBOL_TO_MODULE = {
    "CausalBGM": "bayesgm_torch.models.causalbgm",
    "Sim_Hirano_Imbens_sampler": "bayesgm_torch.datasets.causal_samplers",
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
