"""The model engines and the network facade (``models/networks.py``).
Symbols resolve lazily, so importing one engine does not import the
others."""

_SYMBOL_TO_MODULE = {
    "BGM": "bayesgm_torch.models.bgm",
    "MNISTBGM": "bayesgm_torch.models.mnist",
    "CausalBGM": "bayesgm_torch.models.causalbgm",
    "IdentifiableCausalBGM": "bayesgm_torch.models.identifiable",
    "FullMCMCCausalBGM": "bayesgm_torch.models.fullmcmc",
    "EnsembleCausalBGM": "bayesgm_torch.models.ensemble",
    **{name: "bayesgm_torch.models.networks" for name in (
        "BaseFullyConnectedNet", "BayesianFullyConnectedNet", "BaseVariationalNet",
        "BayesianVariationalNet", "BaseVariationalLowRankNet", "BayesianVariationalLowRankNet",
        "Discriminator", "MCMCFullyConnectedNet", "run_mcmc_for_net", "MNISTEncoderConv",
        "MNISTGenerator", "MNISTDiscriminator")},
}

__all__ = sorted(_SYMBOL_TO_MODULE)


def __getattr__(name):
    module_path = _SYMBOL_TO_MODULE.get(name)
    if module_path is None:
        raise AttributeError(f"module 'bayesgm_torch.models' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module_path), name)
    globals()[name] = value
    return value
