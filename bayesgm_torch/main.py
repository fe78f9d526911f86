"""Run a recipe from ``configs/*.yaml`` on the port (counterpart of the
root ``main.py``: its CausalBGM, BGM and MNIST branches).

    python -m bayesgm_torch.main -c configs/Sim_Colangelo.yaml [-e EPOCHS] [-b EGM_ITERS]
        [--device cuda|cpu]

The config is read by :mod:`bayesgm_torch.utils.config_io` (no PyYAML).  The
causal datasets are Sim_Hirano_Imbens, Sim_Sun and Sim_Colangelo, each with
its closed-form ADRF, against which the RMSE and MAPE of the predicted ADRF
are printed, Semi_Twins (the Twins CSV trio; its ADRF is known too) and
Semi_acic (the ACIC-2018 CSVs, binary treatment: the ATE estimate is
printed), both read from ``$BAYESGM_DATA`` or ``../data``.  The BGM datasets are Sim_low_rank (imputation RMSE and 95 %
coverage of a hidden column) and Sim_heteroskedastic (Pearson correlations
of the predicted outcome of a held-out split, interval coverage and
length).  MNIST fits MNISTBGM on MNIST's training images (a local
``mnist.npz``, else 8192 seeded ellipse images) and inpaints 64 of them
under four masks, printing the mean pixel error and the binarised accuracy
of each.  The optional ``predict:`` and ``fit:`` blocks override predict's
and fit's keyword arguments and are checked against the engine's
signatures before the fit.
"""

from __future__ import annotations

import argparse
import inspect
import os

import numpy as np

SIMULATED = ("Sim_Hirano_Imbens", "Sim_Sun", "Sim_Colangelo")
SEMI_SYNTHETIC = ("Semi_Twins", "Semi_acic")
BGM_DATASETS = ("Sim_heteroskedastic", "Sim_low_rank")
ACIC_UFID = "629e3d2c63914e45b227cc913c09cebe"  # the JAX driver's ACIC-2018 setting
MNIST_TEST_IMAGES = 64  # the inpainting sweep's test images
MNIST_MODES = (  # the inpainting sweep's masks (the JAX driver's)
    dict(mode="lower_half"),
    dict(mode="upper_half"),
    dict(mode="edge_stripe", orientation="horizontal", stripe_pos=14, stripe_width=5),
    dict(mode="hole", center=(14, 14), hole_size=5),
)


def _load_causal_dataset(name):
    """``(x, y, v, truth_fn)`` of a causal dataset at the JAX driver's sizes;
    ``truth_fn(x_grid)`` is the true ADRF (None for Semi_acic, whose
    treatment is binary)."""
    from bayesgm_torch.datasets.causal_samplers import (
        Semi_acic_sampler,
        Semi_Twins_sampler,
        Sim_Colangelo_sampler,
        Sim_Hirano_Imbens_sampler,
        Sim_Sun_sampler,
    )
    from bayesgm_torch.utils.helpers import get_ADRF

    if name == "Sim_Hirano_Imbens":
        ds = Sim_Hirano_Imbens_sampler(N=20000, v_dim=200)
        return (*ds.load_all(), lambda g: get_ADRF(x_values=g, dataset="Imbens"))
    if name == "Sim_Sun":
        ds = Sim_Sun_sampler(N=20000, v_dim=200)
        return (*ds.load_all(), lambda g: get_ADRF(x_values=g, dataset="Sun"))
    if name == "Sim_Colangelo":
        ds = Sim_Colangelo_sampler(N=20000, v_dim=100)
        return (*ds.load_all(), lambda g: get_ADRF(x_values=g, dataset="Lee"))
    if name == "Semi_Twins":
        try:
            ds = Semi_Twins_sampler()
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                "Semi_Twins needs the Twins CSV trio under ../data/Twins "
                "(twin_pairs_{X,T,Y}_3years_samesex.csv); not present in this "
                f"environment: {e}") from e
        # y = -2 sigmoid(3x) + V gamma + eps: the true dose-response is
        # -2 sigmoid(3x) + mean(V gamma)
        const = ds.auxiliary_constant
        return (*ds.load_all(), lambda g: -2.0 / (1.0 + np.exp(-3.0 * np.asarray(g))) + const)
    if name == "Semi_acic":
        try:
            ds = Semi_acic_sampler(ufid=ACIC_UFID)
        except (FileNotFoundError, OSError) as e:
            raise FileNotFoundError(
                "Semi_acic needs the ACIC-2018 CSVs under ../data/ACIC_2018 "
                f"(x.csv + scaling/factuals/<ufid>.csv); not present: {e}") from e
        return (*ds.load_all(), None)
    raise ValueError(f"Unknown causal dataset {name}")


def _predict_overrides(params):
    """Pop and check the optional ``predict:`` block (burn_in, n_mcmc,
    ess_target, q_sd, alpha)."""
    overrides = dict(params.pop("predict", None) or {})
    allowed = {"burn_in", "n_mcmc", "ess_target", "q_sd", "alpha"}
    unknown = set(overrides) - allowed
    if unknown:
        raise ValueError(f"Unknown predict override(s) {sorted(unknown)}; "
                         f"valid keys: {sorted(allowed)}")
    return overrides


def _takes_any_keyword(fn) -> bool:
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in inspect.signature(fn).parameters.values())


def _fit_overrides(params, cls, engine):
    """Pop and check the optional ``fit:`` block (egm_batch_size,
    egm_n_iter, batch_size, epochs_per_eval, startoff) against the
    engine's ``fit`` signature."""
    overrides = dict(params.pop("fit", None) or {})
    allowed = {"egm_batch_size", "egm_n_iter", "batch_size", "epochs_per_eval", "startoff"}
    unknown = set(overrides) - allowed
    if unknown:
        raise ValueError(f"Unknown fit override(s) {sorted(unknown)}; "
                         f"valid keys: {sorted(allowed)}")
    if not _takes_any_keyword(cls.fit):
        unsupported = set(overrides) - set(inspect.signature(cls.fit).parameters)
        if unsupported:
            raise ValueError(f"fit override(s) {sorted(unsupported)} not supported by "
                             f"model '{engine}' ({cls.__name__}.fit)")
    return overrides


def _check_overrides_against_engine(cls, engine, predict_overrides):
    """Raise before the fit if a predict override is not a keyword of the
    engine's ``predict`` (a ``**kwargs`` predict takes anything)."""
    if _takes_any_keyword(cls.predict):
        return
    unsupported = set(predict_overrides) - set(inspect.signature(cls.predict).parameters)
    if unsupported:
        raise ValueError(f"predict override(s) {sorted(unsupported)} not supported by "
                         f"model '{engine}' ({cls.__name__}.predict)")


def run_causal(params, epochs, egm_iters, device="cuda"):
    """Fit and predict the config's engine on its dataset; prints the ATE
    (binary) or the ADRF's RMSE and MAPE against the truth (continuous) and
    returns ``(causal_pre, pos_intervals)``.  The optional ``model:`` key
    picks the engine: ``causalbgm`` (the default), ``identifiable``,
    ``fullmcmc`` (its weight-space HMC runs between fit and predict) or
    ``ensemble``."""
    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.models.ensemble import EnsembleCausalBGM
    from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM
    from bayesgm_torch.models.identifiable import IdentifiableCausalBGM

    x, y, v, truth_fn = _load_causal_dataset(params["dataset"])
    engines = {"causalbgm": CausalBGM, "identifiable": IdentifiableCausalBGM,
               "fullmcmc": FullMCMCCausalBGM, "ensemble": EnsembleCausalBGM}
    predict_overrides = _predict_overrides(params)
    engine = params.pop("model", "causalbgm")
    if engine not in engines:
        raise ValueError(f"Unknown model '{engine}'; valid options: {sorted(engines)}")
    cls = engines[engine]
    _check_overrides_against_engine(cls, engine, predict_overrides)
    fit_overrides = _fit_overrides(params, cls, engine)
    model = cls(params=params, random_seed=None, device=device)
    fit_kwargs = dict(epochs=epochs, epochs_per_eval=10, use_egm_init=True,
                      egm_n_iter=egm_iters, egm_batches_per_eval=500, verbose=1)
    fit_kwargs.update(fit_overrides)
    model.fit(data=(x, y, v), **fit_kwargs)
    if engine == "fullmcmc":
        # predict needs the posterior weight samples
        model.run_mcmc_training((x, y, v))

    kwargs = dict(alpha=0.01, n_mcmc=3000, burn_in=5000, q_sd=1.0)
    kwargs.update(predict_overrides)
    if params.get("binary_treatment"):
        causal_pre, pos_intervals = model.predict(data=(x, y, v), **kwargs)
        print("ATE estimate:", float(np.mean(causal_pre)))
        return causal_pre, pos_intervals
    # Hirano-Imbens on the reference tutorial's [0, 3] grid, the others on
    # the in-sample [p5, p95]; one full-data batch (bs = n).
    if params["dataset"] == "Sim_Hirano_Imbens":
        x_grid = np.linspace(0, 3, 20)
    else:
        lo, hi = np.quantile(x, [0.05, 0.95])
        x_grid = np.linspace(lo, hi, 20)
    causal_pre, pos_intervals = model.predict(data=(x, y, v), x_values=x_grid, bs=len(x),
                                              **kwargs)
    if truth_fn is not None:
        true = np.asarray(truth_fn(x_grid.astype("float32")))
        rmse = float(np.sqrt(np.mean((causal_pre - true) ** 2)))
        mape = float(np.mean(np.abs((causal_pre - true) / true)))
        print(f"ADRF RMSE: {rmse:.4f}  MAPE: {mape:.4f}")
    return causal_pre, pos_intervals


def _load_bgm_dataset(params):
    """``(train, X_test, Y_test)`` at the JAX driver's sizes: Sim_low_rank's
    10000 rows (no test split: None, None), or Sim_heteroskedastic's 20000
    rows of ``simulate_z_hetero`` (``z_dim`` factors, ``x_dim - 1``
    covariates) with the last 10 % held out and the outcome as the train
    matrix's last column."""
    from bayesgm_torch.datasets.simulators import simulate_low_rank_data, simulate_z_hetero

    if params["dataset"] == "Sim_low_rank":
        data, _ = simulate_low_rank_data(n_samples=10000, z_dim=params["z_dim"],
                                         x_dim=params["x_dim"])
        return data, None, None
    X, Y = simulate_z_hetero(n=20000, k=params.get("z_dim", 3), d=params["x_dim"] - 1)
    n_test = len(X) // 10
    train = np.hstack([X[:-n_test], Y[:-n_test].reshape(-1, 1)]).astype("float32")
    return train, X[-n_test:], Y[-n_test:]


def run_bgm(params, epochs, egm_iters, device="cuda"):
    """Fit BGM on the config's dataset and evaluate its imputation.

    Sim_low_rank: hide column 0 of the first 1000 training rows, impute it
    (3000 + 3000 HMC steps) and print the RMSE and the 95 % interval's
    coverage; returns ``(imputed, intervals)``.  Sim_heteroskedastic: NaN the
    outcome of the held-out split, predict it (5000 + 5000 steps, ``bs=500``)
    and print the Pearson correlations of the posterior mean and median with
    the truth and the interval's coverage and mean length; writes
    ``data_pred_heter.npz`` to the results folder and returns ``(y_mean,
    intervals)``.  An optional ``predict:`` block overrides ``burn_in``,
    ``n_mcmc`` and ``alpha``."""
    from bayesgm_torch.models.bgm import BGM

    predict_overrides = _predict_overrides(params)
    _check_overrides_against_engine(BGM, "bgm", predict_overrides)
    fit_overrides = _fit_overrides(params, BGM, "bgm")
    data, X_test, Y_test = _load_bgm_dataset(params)
    model = BGM(params=params, random_seed=123, device=device)
    fit_kwargs = dict(epochs=epochs, epochs_per_eval=10, use_egm_init=True,
                      egm_n_iter=egm_iters, egm_batches_per_eval=500, verbose=1)
    fit_kwargs.update(fit_overrides)
    model.fit(data=data, **fit_kwargs)

    if X_test is None:
        test = np.array(data[:1000])
        truth = test[:, 0].copy()
        test[:, 0] = np.nan
        kwargs = dict(alpha=0.05, n_mcmc=3000, burn_in=3000)
        kwargs.update(predict_overrides)
        imputed, intervals = model.predict(test, **kwargs)
        rmse = float(np.sqrt(np.mean((imputed[:, 0] - truth) ** 2)))
        covered = np.mean((intervals[:, 0, 0] <= truth) & (truth <= intervals[:, 0, 1]))
        print(f"Imputation RMSE: {rmse:.4f}  95%-interval coverage: {covered:.3f}")
        return imputed, intervals

    from scipy.stats import pearsonr

    data_test = np.hstack([X_test, np.full((len(X_test), 1), np.nan)]).astype("float32")
    kwargs = dict(alpha=0.05, n_mcmc=5000, burn_in=5000)
    kwargs.update(predict_overrides)
    cube, intervals = model.predict(data_test, bs=500, return_samples=True, **kwargs)
    y_draws = cube[:, :, -1]  # (n_mcmc, n_test)
    y_mean, y_median = y_draws.mean(axis=0), np.median(y_draws, axis=0)
    corr_mean = pearsonr(Y_test, y_mean)[0]
    corr_median = pearsonr(Y_test, y_median)[0]
    covered = np.mean((intervals[:, 0, 0] <= Y_test) & (Y_test <= intervals[:, 0, 1]))
    length = float(np.mean(intervals[:, 0, 1] - intervals[:, 0, 0]))
    print(f"Pearson corr (posterior mean): {corr_mean:.4f}")
    print(f"Pearson corr (posterior median): {corr_median:.4f}")
    print(f"95%-interval coverage: {covered:.3f}  mean length: {length:.3f}")
    os.makedirs(model.save_dir, exist_ok=True)
    np.savez(f"{model.save_dir}/data_pred_heter.npz",
             y_mean=y_mean, y_median=y_median, pred_interval=intervals)
    return y_mean, intervals


def _load_mnist_images():
    from bayesgm_torch.datasets.images import load_mnist_images

    return load_mnist_images()


def run_mnist(params, epochs, egm_iters, device="cuda"):
    """Fit MNISTBGM on the training images, then inpaint the first 64 under
    each of :data:`MNIST_MODES` (one subject batch, 2000 + 2000 HMC steps,
    or a ``predict:`` block's ``burn_in``, ``n_mcmc`` and ``alpha``): prints
    each mask's mean absolute pixel error and binarised accuracy over the
    missing pixels, writes ``data_pred_mnist_{mode}.npz`` to the results
    folder and returns ``{mode: (error, accuracy)}``."""
    from bayesgm_torch.models.mnist import MNISTBGM
    from bayesgm_torch.utils.helpers import mnist_mask_indices

    predict_overrides = _predict_overrides(params)
    _check_overrides_against_engine(MNISTBGM, "mnist", predict_overrides)
    fit_overrides = _fit_overrides(params, MNISTBGM, "mnist")
    data = _load_mnist_images()
    model = MNISTBGM(params=params, random_seed=123, device=device)
    fit_kwargs = dict(epochs=epochs, epochs_per_eval=10, use_egm_init=True,
                      egm_n_iter=egm_iters, egm_batches_per_eval=500, verbose=1)
    fit_kwargs.update(fit_overrides)
    model.fit(data=data, **fit_kwargs)

    n_test = MNIST_TEST_IMAGES
    kwargs = dict(alpha=0.05, n_mcmc=2000, burn_in=2000)
    kwargs.update(predict_overrides)
    os.makedirs(model.save_dir, exist_ok=True)
    results = {}
    for mk in MNIST_MODES:
        _, miss = mnist_mask_indices(**mk)
        test = np.array(data[:n_test]).reshape(n_test, -1)
        truth = test[:, miss].copy()
        test[:, miss] = np.nan
        imputed, intervals = model.predict(test.reshape(n_test, 28, 28, 1), bs=n_test, **kwargs)
        pred = imputed.reshape(n_test, -1)[:, miss]
        err = float(np.mean(np.abs(pred - truth)))
        acc = float(np.mean((pred > 0.5) == (truth > 0.5)))
        results[mk["mode"]] = (err, acc)
        print(f"Inpainting [{mk['mode']}]: mean pixel error {err:.4f}, "
              f"binarized accuracy {acc:.3f}")
        np.savez(f"{model.save_dir}/data_pred_mnist_{mk['mode']}.npz",
                 imputed=imputed, pred_interval=np.asarray(intervals, dtype=object))
    return results


def main(argv=None):
    from bayesgm_torch.utils import config_io

    parser = argparse.ArgumentParser(prog="python -m bayesgm_torch.main")
    parser.add_argument("-c", "--config", type=str, required=True, help="path to config file")
    parser.add_argument("-e", "--epochs", type=int, default=100)
    parser.add_argument("-b", "--batches", type=int, default=30000, help="EGM iterations")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU (default) or the CPU")
    args = parser.parse_args(argv)
    params = config_io.load(args.config)
    dataset = params["dataset"]
    if dataset in SIMULATED or dataset in SEMI_SYNTHETIC:
        return run_causal(params, args.epochs, args.batches, device=args.device)
    if dataset in BGM_DATASETS:
        return run_bgm(params, args.epochs, args.batches, device=args.device)
    if dataset == "MNIST":
        return run_mnist(params, args.epochs, args.batches, device=args.device)
    raise ValueError(f"Unknown dataset {dataset}")


if __name__ == "__main__":
    main()
