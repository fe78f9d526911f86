"""Chains of two packages from one fit, compared by one score: reads the
JSON lines that ``tools/fullmcmc_stage_split.py`` (the port) and
``tests/_jax_fullmcmc_reference.py`` (the JAX package) print, keeps each
run's first stage-C line (its ``predict`` 1), and prints one JSON line:
every chain's score per package, each package's mean and standard
deviation, the difference of the means with its standard error, and the
two-sided Mann-Whitney U p-value of the two sets.

A file's package is read from its lines (the JAX script's lines carry
``"package": "jax"``); the score is binary_ate's ``d_ate``.

    python tools/chain_compare.py LOG [LOG ...]
"""

from __future__ import annotations

import argparse
import json
import math

from scipy.stats import mannwhitneyu

KEY = "d_ate"  # the score compared


def first_c_line(path):
    """The first stage-C line of one run's output, or None."""
    with open(path) as f:
        for line in f:
            if line.startswith("{"):
                rec = json.loads(line)
                if rec.get("stage") == "C" and rec.get("predict", 1) == 1:
                    return rec
    return None


def compare(paths):
    """The comparison's JSON object for the runs in ``paths``."""
    chains = {"port": [], "jax": []}
    for path in paths:
        rec = first_c_line(path)
        if rec is not None:
            chains[rec.get("package", "port")].append((path, rec[KEY], rec.get("seed")))
    out = dict(key=KEY)
    for name, runs in chains.items():
        vals = [v for _, v, _ in runs]
        mean = sum(vals) / len(vals) if vals else float("nan")
        sd = (math.sqrt(sum((v - mean) ** 2 for v in vals) / (len(vals) - 1))
              if len(vals) > 1 else float("nan"))
        out[name] = dict(n=len(vals), mean=mean, sd=sd,
                         chains=[dict(seed=s, value=v, log=p) for p, v, s in runs])
    p, j = out["port"], out["jax"]
    if p["n"] > 1 and j["n"] > 1:
        out["mean_diff"] = p["mean"] - j["mean"]
        out["se_diff"] = math.sqrt(p["sd"] ** 2 / p["n"] + j["sd"] ** 2 / j["n"])
        out["mann_whitney_p"] = float(mannwhitneyu(
            [c["value"] for c in p["chains"]], [c["value"] for c in j["chains"]],
            alternative="two-sided").pvalue)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logs", nargs="+")
    a = ap.parse_args(argv)
    print(json.dumps(compare(a.logs)))


if __name__ == "__main__":
    main()
