"""The port's command line: ``python -m bayesgm_torch causalbgm ...`` and
``python -m bayesgm_torch bgm ...`` (port of the two subcommands and the flat
``main_causalbgm`` entry of ``bayesgm_tpu/cli/cli.py``, with the same flags
plus ``--device``).

``causalbgm`` reads an ``(x, y, v)`` triplet (.npz, .csv or .txt), fits
CausalBGM, predicts the ITE (binary treatment) or the ADRF on
``--x_values`` (continuous), and writes ``causal_effect_point_estimate.*``
and ``causal_effect_posterior_interval.*`` to the model's results folder.
``bgm`` reads one data matrix with NaN-encoded missing entries,
standardises each column over its observed entries, fits BGM on the
complete rows, imputes the missing entries by HMC and writes
``imputed_data.*`` and ``prediction_intervals.npz``.  (The JAX package's
``bgm`` standardises with NaN-blind means, so a column with one hole turns
wholly NaN, and fits on every row.)
"""

from __future__ import annotations

import argparse

import numpy as np

from bayesgm_torch import __version__


def _add_common_args(parser):
    parser.add_argument("-o", "--output_dir", type=str, required=True,
                        help="Directory where results and models are written.")
    parser.add_argument("-i", "--input", type=str, required=True,
                        help="Path to the input data (.csv, .txt, or .npz).")
    parser.add_argument("-t", "--delimiter", type=str, default="\t",
                        help="Column separator for csv/txt inputs (default: tab '\\t').")
    parser.add_argument("-d", "--dataset", type=str, default="Mydata",
                        help="Name used to label the output sub-directory.")
    parser.add_argument("-F", "--save_format", type=str, default="txt",
                        help="File format for saved outputs (default: txt).")
    parser.add_argument("-save_model", default=False, action=argparse.BooleanOptionalAction,
                        help="Checkpoint the full training state at every eval epoch.")
    parser.add_argument("-save_res", default=True, action=argparse.BooleanOptionalAction,
                        help="Write intermediate evaluation artifacts during training.")
    parser.add_argument("--use_bnn", default=True, action=argparse.BooleanOptionalAction,
                        help="Model the outcome/treatment heads as Bayesian (flipout) layers.")
    parser.add_argument("--use_egm_init", default=True, action=argparse.BooleanOptionalAction,
                        help="Warm-start the latent table with the adversarial EGM stage.")
    parser.add_argument("--seed", type=int, default=123,
                        help="Seed of the model's init and random streams (default: 123).")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="Run on the GPU (default; fails without CUDA) or the CPU.")


def _add_causalbgm_args(parser):
    parser.add_argument("-B", "--binary_treatment", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="Treat X as binary (ITE) instead of continuous (ADRF).")
    parser.add_argument("-Z", "--z_dims", type=int, nargs="+", default=[3, 3, 6, 6],
                        help="Sizes of the four latent blocks z0..z3 (default: [3, 3, 6, 6]).")
    parser.add_argument("--lr_theta", type=float, default=0.0001,
                        help="Adam rate for the network weights in iterative updating (default: 0.0001).")
    parser.add_argument("--lr_z", type=float, default=0.0001,
                        help="Adam rate for the per-sample latent table (default: 0.0001).")
    parser.add_argument("--x_values", type=float, nargs="+",
                        help="Treatment grid for the dose-response curve, e.g. --x_values 0.5 1.0 1.5.")
    parser.add_argument("--g_units", type=int, nargs="+", default=[64, 64, 64, 64, 64],
                        help="Hidden-layer widths of the covariate decoder g.")
    parser.add_argument("--f_units", type=int, nargs="+", default=[64, 32, 8],
                        help="Hidden-layer widths of the outcome head f.")
    parser.add_argument("--h_units", type=int, nargs="+", default=[64, 32, 8],
                        help="Hidden-layer widths of the treatment head h.")
    parser.add_argument("--kl_weight", type=float, default=0.0001,
                        help="Weight on the variational KL penalty of the Bayesian layers.")
    parser.add_argument("--lr", type=float, default=0.0001,
                        help="Adam rate used during the EGM warm-start stage.")
    parser.add_argument("--g_d_freq", type=int, default=5,
                        help="Discriminator steps per generator step in the EGM stage.")
    parser.add_argument("--e_units", type=int, nargs="+", default=[64, 64, 64, 64, 64],
                        help="Hidden-layer widths of the encoder e.")
    parser.add_argument("--dz_units", type=int, nargs="+", default=[64, 32, 8],
                        help="Hidden-layer widths of the latent-space critic.")
    parser.add_argument("--use-z-rec", default=True, action=argparse.BooleanOptionalAction,
                        help="Add the latent round-trip reconstruction loss in EGM (default: on).")
    parser.add_argument("-N", "--n_iter", type=int, default=30000,
                        help="EGM warm-start steps (default: 30000).")
    parser.add_argument("--startoff", type=int, default=0,
                        help="Skip evaluation before this training iteration (default: 0).")
    parser.add_argument("--batches_per_eval", type=int, default=500,
                        help="Evaluate every this many EGM iterations (default: 500).")
    parser.add_argument("-E", "--epochs", type=int, default=100,
                        help="Epochs of the iterative (post-EGM) updating stage.")
    parser.add_argument("-M", "--n_mcmc", type=int, default=3000,
                        help="Posterior draws kept per chain at predict time (default: 3000).")
    parser.add_argument("--burn_in", type=int, default=5000,
                        help="Discarded MH warm-up steps before collection (default: 5000).")
    parser.add_argument("-q", "--q_sd", type=float, default=1.0,
                        help="Random-walk proposal scale; <=0 switches to adaptive tuning (default: 1.0).")
    parser.add_argument("--epochs_per_eval", type=int, default=10,
                        help="Evaluate every this many epochs (default: 10).")
    parser.add_argument("--alpha", type=float, default=0.01,
                        help="Credible-interval tail mass, e.g. 0.01 for 99-percent intervals (default: 0.01).")


def _build_causalbgm_parser(subparsers):
    parser = subparsers.add_parser(
        "causalbgm",
        help="Run CausalBGM for causal inference in observational studies",
        description="CausalBGM: An AI-powered Bayesian generative modeling approach "
                    "for causal inference in observational studies")
    _add_common_args(parser)
    _add_causalbgm_args(parser)
    parser.set_defaults(func=_run_causalbgm)
    return parser


def _build_bgm_parser(subparsers):
    parser = subparsers.add_parser(
        "bgm",
        help="Run BGM for Bayesian generative modeling (data generation and imputation)",
        description="BGM: A Bayesian generative modeling approach for data generation "
                    "and missing data imputation")
    _add_common_args(parser)
    parser.add_argument("--z_dim", type=int, default=10, help="Width of the latent code Z (default: 10).")
    parser.add_argument("--g_units", type=int, nargs="+", default=[64, 64, 64, 64, 64],
                        help="Hidden-layer widths of the decoder g.")
    parser.add_argument("--e_units", type=int, nargs="+", default=[64, 64, 64, 64, 64],
                        help="Hidden-layer widths of the encoder e.")
    parser.add_argument("--dz_units", type=int, nargs="+", default=[64, 32, 8],
                        help="Hidden-layer widths of the latent-space critic.")
    parser.add_argument("--dx_units", type=int, nargs="+", default=[64, 32, 8],
                        help="Hidden-layer widths of the data-space critic.")
    parser.add_argument("--lr_theta", type=float, default=0.0001,
                        help="Adam rate for network weights in iterative updating.")
    parser.add_argument("--lr_z", type=float, default=0.0001,
                        help="Adam rate for the per-sample latent table.")
    parser.add_argument("--lr", type=float, default=0.0001,
                        help="Adam rate used during the EGM warm-start stage.")
    parser.add_argument("--kl_weight", type=float, default=0.0001,
                        help="Weight on the variational KL penalty of the Bayesian layers.")
    parser.add_argument("--g_d_freq", type=int, default=5,
                        help="Discriminator steps per generator step in the EGM stage.")
    parser.add_argument("--gamma", type=float, default=10.0,
                        help="Gradient-penalty strength on the EGM critics.")
    parser.add_argument("--egm_reg_alpha", type=float, default=0.01,
                        help="Variance-regularizer weight in EGM generator training.")
    parser.add_argument("-N", "--egm_n_iter", type=int, default=20000,
                        help="EGM warm-start steps (default: 20000).")
    parser.add_argument("--egm_batches_per_eval", type=int, default=500,
                        help="Evaluate every this many EGM iterations.")
    parser.add_argument("-E", "--epochs", type=int, default=100,
                        help="Epochs of the iterative (post-EGM) updating stage.")
    parser.add_argument("--epochs_per_eval", type=int, default=5,
                        help="Evaluate every this many epochs.")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="Mini-batch size for training (default: 32).")
    parser.add_argument("--alpha", type=float, default=0.05,
                        help="Prediction-interval tail mass (default: 0.05).")
    parser.add_argument("-M", "--n_mcmc", type=int, default=5000,
                        help="Posterior draws kept by the HMC sampler (default: 5000).")
    parser.add_argument("--burn_in", type=int, default=5000,
                        help="Discarded HMC warm-up steps (default: 5000).")
    parser.add_argument("--step_size", type=float, default=0.01,
                        help="Leapfrog integrator step size for HMC.")
    parser.add_argument("--num_leapfrog_steps", type=int, default=10,
                        help="Leapfrog steps per HMC proposal.")
    parser.set_defaults(func=_run_bgm)
    return parser


def _run_bgm(args):
    from bayesgm_torch.models.bgm import BGM
    from bayesgm_torch.utils.data_io import parse_file, save_data

    params = vars(args)
    params.pop("func", None)
    device = params.pop("device")
    # Standardise each column over its observed entries, so that a NaN hole
    # stays a hole instead of spreading over its column, and fit on the
    # complete rows: predict then imputes the holes.
    data = parse_file(args.input, sep=params["delimiter"], normalize=False)
    std = np.nanstd(data, axis=0)
    data = ((data - np.nanmean(data, axis=0)) / np.where(std == 0.0, 1.0, std)).astype("float32")
    complete = ~np.isnan(data).any(axis=1)
    if not complete.any():
        raise ValueError(f"{args.input}: every row has a missing entry; BGM fits on the "
                         "complete rows")
    params["x_dim"] = data.shape[1]

    # 'alpha' names two things: the significance level goes to predict, the
    # EGM variance regulariser to the model.
    predict_alpha = params.pop("alpha")
    params["alpha"] = params.pop("egm_reg_alpha")

    model = BGM(params=params, random_seed=params.get("seed"), device=device)
    model.fit(
        data=data[complete],
        batch_size=params["batch_size"],
        epochs=params["epochs"],
        epochs_per_eval=params["epochs_per_eval"],
        use_egm_init=params["use_egm_init"],
        egm_n_iter=params["egm_n_iter"],
        egm_batches_per_eval=params["egm_batches_per_eval"],
        verbose=1,
    )
    data_imputed, pred_interval = model.predict(
        data=data, alpha=predict_alpha, n_mcmc=params["n_mcmc"], burn_in=params["burn_in"],
        step_size=params["step_size"], num_leapfrog_steps=params["num_leapfrog_steps"],
        seed=params.get("seed", 42))

    save_data("{}/imputed_data.{}".format(model.save_dir, params["save_format"]), data_imputed)
    if isinstance(pred_interval, list):  # a ragged pattern: one (n_missing_i, 2) array per row
        ragged = np.empty(len(pred_interval), dtype=object)
        for i, a in enumerate(pred_interval):
            ragged[i] = a
        pred_interval = ragged
    np.savez("{}/prediction_intervals.npz".format(model.save_dir), intervals=pred_interval)


def _run_causalbgm(args):
    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.utils.data_io import parse_file_triplet, save_data

    params = vars(args)
    params.pop("func", None)
    device = params.pop("device")
    data = parse_file_triplet(args.input, sep=params["delimiter"])
    params["v_dim"] = data[-1].shape[1]

    model = CausalBGM(params=params, random_seed=params.get("seed"), device=device)
    model.fit(
        data=data,
        epochs=params["epochs"],
        epochs_per_eval=params["epochs_per_eval"],
        startoff=params["startoff"],
        use_egm_init=params["use_egm_init"],
        egm_n_iter=params["n_iter"],
        egm_batches_per_eval=params["batches_per_eval"],
        verbose=1,
    )

    predict_kwargs = dict(
        data=data, alpha=params["alpha"], n_mcmc=params["n_mcmc"],
        burn_in=params["burn_in"], q_sd=params["q_sd"])
    if not params["binary_treatment"]:
        predict_kwargs["x_values"] = params["x_values"]
    causal_pre, pos_intervals = model.predict(**predict_kwargs)

    save_data("{}/causal_effect_point_estimate.{}".format(model.save_dir, params["save_format"]),
              causal_pre)
    save_data("{}/causal_effect_posterior_interval.{}".format(model.save_dir,
                                                             params["save_format"]),
              pos_intervals)


def main(args=None):
    """``python -m bayesgm_torch`` with the ``causalbgm`` and ``bgm``
    subcommands."""
    parser = argparse.ArgumentParser(
        "bayesgm_torch",
        description=f"BayesGM on PyTorch: Bayesian generative modeling - v{__version__}")
    parser.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    subparsers = parser.add_subparsers(
        title="commands", description="Available model commands", dest="command")
    _build_causalbgm_parser(subparsers)
    _build_bgm_parser(subparsers)

    args = parser.parse_args(args)
    if args.command is None:
        parser.print_help()
        return
    args.func(args)


def main_causalbgm(args=None):
    """The flat-argument CausalBGM entry (the ``causalbgm`` flags, no
    subcommand)."""
    parser = argparse.ArgumentParser(
        "causalBGM",
        description="CausalBGM: An AI-powered Bayesian generative modeling approach "
                    f"for causal inference - v{__version__}")
    _add_common_args(parser)
    _add_causalbgm_args(parser)
    _run_causalbgm(parser.parse_args(args))


# Backward-compatible alias (the JAX package's ``causalBGM`` script name).
legacy_main = main_causalbgm
