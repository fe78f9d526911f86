"""The port's hand-written CUDA kernels in one namespace (counterpart of
``bayesgm_tpu/ops/pallas_kernels.py``, the JAX package's import-only facade
over its Pallas kernel families).

Import-only: it re-exports, from the modules that hold them, the port's
counterpart of every name that facade re-exports and the port has:

- ``ops/_pk_bnn_hosteps.py``: K1 and K2, the flipout log posterior (and its
  z-gradient) with the weight noise from the host (``csrc/bnn_hosteps.cu``);
- ``ops/_pk_plain.py``: K4 and K3, the plain-MLP log posterior (and its
  z-gradient) (``csrc/plain.cu``);
- ``ops/_pk_bnn_inkernel.py``: K6, K7 and K5, the flipout family with the
  noise drawn in the kernel, and the MH window (``csrc/bnn_inkernel.cu``);
- ``ops/_pk_util.py``: the host-side flattening, layer dims, block sizing
  and noise draws the wrappers take;
- ``ops/_pk_traced_common.py``: the Philox draws the kernels and their
  plain versions share.

The JAX facade's other names are pieces of the traced TPU kernel bodies
(the ``_mlp_chain``/``_flipout_chain`` families, the on-core sign source,
``key_to_seed``, ``on_tpu``): the CUDA sources hold their counterparts and
the plain versions sit beside each wrapper.
"""

from bayesgm_torch.ops.nn import LEAKY_SLOPE
from bayesgm_torch.ops._pk_traced_common import (
    _kernel_normal,
    _kernel_uniform,
    _leaky,
    _sign_source,
)
from bayesgm_torch.ops._pk_util import (
    _round_up,
    bnn_block_rows,
    flatten_flipout_params,
    flatten_mlp_params,
    flipout_mlp_layer_dims,
    flipout_step_perturbations,
    mlp_layer_dims,
    pick_block_rows,
    split_flipout_flat,
)
from bayesgm_torch.ops._pk_plain import (
    make_fused_causal_logp,
    make_fused_causal_logp_and_grad,
)
from bayesgm_torch.ops._pk_bnn_inkernel import (
    make_fused_causal_logp_and_grad_bnn,
    make_fused_causal_logp_bnn,
    make_fused_mh_steps_bnn,
)
from bayesgm_torch.ops._pk_bnn_hosteps import (
    make_fused_causal_logp_and_grad_bnn_hosteps,
    make_fused_causal_logp_bnn_hosteps,
)

__all__ = [
    "LEAKY_SLOPE",
    "_kernel_normal",
    "_kernel_uniform",
    "_leaky",
    "_sign_source",
    "_round_up",
    "bnn_block_rows",
    "flatten_flipout_params",
    "flatten_mlp_params",
    "flipout_mlp_layer_dims",
    "flipout_step_perturbations",
    "mlp_layer_dims",
    "pick_block_rows",
    "split_flipout_flat",
    "make_fused_causal_logp",
    "make_fused_causal_logp_and_grad",
    "make_fused_causal_logp_and_grad_bnn",
    "make_fused_causal_logp_bnn",
    "make_fused_mh_steps_bnn",
    "make_fused_causal_logp_and_grad_bnn_hosteps",
    "make_fused_causal_logp_bnn_hosteps",
]
