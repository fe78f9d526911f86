"""``tools/mnist_stage_split.py --read_every``: the read-outs between epochs
come at epochs 0, K, 2K, ..., the last one the final nets', and they leave
the fit as it was (the final line and the saved nets equal a run without
them).  A cut size: 96 images, narrow filters, EGM 2, epochs 0..2."""

import contextlib
import importlib.util
import io
import json
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch.models import mnist as tmn  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _run(monkeypatch, tmp_path, tag, extra):
    spec = importlib.util.spec_from_file_location("_tool_mnist_stage_split",
                                                  REPO / "tools" / "mnist_stage_split.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    images = tool.make_ellipse_images
    with monkeypatch.context() as mp:
        mp.setattr(tool, "make_ellipse_images", lambda n, seed: images(96, seed=seed))
        for name, width in (("GEN_FILTERS", 4), ("ENC_FILTERS", 4), ("DISC_FILTERS", 8)):
            mp.setattr(tmn, name, width)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main(["--device", "cpu", "--seed", "3", "--egm", "2", "--epochs", "2",
                       "--save_nets", str(tmp_path / tag), *extra])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    with open(tmp_path / f"{tag}.final.pkl", "rb") as f:
        return lines, pickle.load(f)


def test_read_every_reads_between_epochs_and_leaves_the_fit(monkeypatch, tmp_path):
    plain, plain_nets = _run(monkeypatch, tmp_path, "plain", [])
    read, read_nets = _run(monkeypatch, tmp_path, "read", ["--read_every", "1"])
    assert [x["stage"] for x in plain] == ["post_egm", "final"]
    assert [(x["stage"], x.get("epoch")) for x in read] == [
        ("post_egm", None), ("epoch", 0), ("epoch", 1), ("epoch", 2), ("final", None)]
    keys = ("mse_reconstruction", "mean_var", "mse_sigmoid_mu")
    for k in keys:
        assert read[-1][k] == plain[-1][k] == read[-2][k]
        assert all(np.isfinite(x[k]) for x in read)
    assert read[1]["mse_sigmoid_mu"] != read[3]["mse_sigmoid_mu"]  # the nets moved
    for a, b in zip(torch.utils._pytree.tree_leaves(plain_nets),
                    torch.utils._pytree.tree_leaves(read_nets)):
        np.testing.assert_array_equal(a, b)
