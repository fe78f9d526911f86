"""Data layer: the mini-batch sampler, the causal simulations and the
semi-synthetic ACIC-2018 and Twins loaders, the prior samplers, the
simulators (numpy copies of ``bayesgm_tpu/datasets``) and MNIST-shaped
images."""

from bayesgm_torch.datasets.base_sampler import Base_sampler
from bayesgm_torch.datasets.causal_samplers import (
    Semi_acic_sampler,
    Semi_Twins_sampler,
    Sim_Colangelo_sampler,
    Sim_Hirano_Imbens_sampler,
    Sim_Sun_sampler,
)
from bayesgm_torch.datasets.images import load_mnist_images, make_ellipse_images
from bayesgm_torch.datasets.prior_samplers import (
    Gaussian_sampler,
    GMM_indep_sampler,
    Swiss_roll_sampler,
)
from bayesgm_torch.datasets.simulators import (
    simulate_heteroskedastic_data,
    simulate_low_rank_data,
    simulate_regression,
    simulate_z_hetero,
)

__all__ = [
    "Base_sampler",
    "Semi_acic_sampler",
    "Semi_Twins_sampler",
    "Sim_Hirano_Imbens_sampler",
    "Sim_Sun_sampler",
    "Sim_Colangelo_sampler",
    "Gaussian_sampler",
    "GMM_indep_sampler",
    "Swiss_roll_sampler",
    "simulate_regression",
    "simulate_low_rank_data",
    "simulate_heteroskedastic_data",
    "simulate_z_hetero",
    "make_ellipse_images",
    "load_mnist_images",
]
