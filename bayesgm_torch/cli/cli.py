"""The port's command line: ``python -m bayesgm_torch causalbgm ...`` (port
of the ``causalbgm`` subcommand and the flat ``main_causalbgm`` entry of
``bayesgm_tpu/cli/cli.py``, with the same flags plus ``--device``).

It reads an ``(x, y, v)`` triplet (.npz, .csv or .txt), fits CausalBGM,
predicts the ITE (binary treatment) or the ADRF on ``--x_values``
(continuous), and writes ``causal_effect_point_estimate.*`` and
``causal_effect_posterior_interval.*`` to the model's results folder.  The
``bgm`` subcommand waits for the port of BGM.
"""

from __future__ import annotations

import argparse

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
    """``python -m bayesgm_torch`` with the ``causalbgm`` subcommand."""
    parser = argparse.ArgumentParser(
        "bayesgm_torch",
        description=f"BayesGM on PyTorch: Bayesian generative modeling - v{__version__}")
    parser.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    subparsers = parser.add_subparsers(
        title="commands", description="Available model commands", dest="command")
    _build_causalbgm_parser(subparsers)

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
