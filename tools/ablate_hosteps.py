#!/usr/bin/env python3
"""Where the time of K1 and K2 goes, by ablation, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/ablate_hosteps.py [--reps 20]

It builds variants of ``bayesgm_torch/csrc/bnn_hosteps.cu`` that each drop
or swap one part of a kernel (by a textual substitution, checked to apply),
and times every variant's device time per launch with torch.profiler at the
main path's shapes: K1 over the paired 2n = 40000 rows and K2 over fit's 32
rows (and, for the choice between K2's two forms, 256 to 20000 rows), at the
width of the repo's flagship configuration with random weights from seed 123.
A variant's values are wrong on purpose: only its time means anything.
Prints one JSON line per measurement and the card's name and power limit.
Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
SOURCE = "bayesgm_torch/csrc/bnn_hosteps.cu"
K2_ROWS = (32, 256, 512, 1024, 20000)

# name -> (kernel it probes, what it drops, [(old, new), ...])
VARIANTS = {
    "base": ("K1+K2", "nothing", []),
    "k1_noprod": ("K1", "the products' inner loop", [
        ("#pragma unroll 8\n    for (int k = 0; k < in; ++k) {",
         "#pragma unroll 8\n    for (int k = 0; k < 0; ++k) {"),
        ("#pragma unroll 4\n      for (int k = 0; k < in; ++k) {\n        const float a = act",
         "#pragma unroll 4\n      for (int k = 0; k < 0; ++k) {\n        const float a = act")]),
    "k1_noepi": ("K1", "the 4 x 4 micro-tiles' epilogue", [
        ("k1_epilogue<4>(p, e, r0, q.col0 + c0, out, bs + c0, am, ap, tv);",
         "if (am[0][0] == 1.2345f && ap[3][3] == 3.f) "
         "k1_epilogue<4>(p, e, r0, q.col0 + c0, out, bs + c0, am, ap, tv);")]),
    "k1_noload": ("K1", "the weight panels' copies", [
        ("  const Panel q = panel_at(p, pc);\n  const Chain& c",
         "  if (pc >= 0) return;\n  const Panel q = panel_at(p, pc);\n  const Chain& c")]),
    "nophilox": ("K1+K2", "Philox (a hash makes the sign words)", [
        ("      w = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)c4,\n"
         "                                   (uint32_t)chain, (uint32_t)group), key);",
         "      w = make_uint4((uint32_t)(row0 + r) * 2654435761u, (uint32_t)c4 * 40503u,"
         " (uint32_t)chain, key.x);")]),
    "k2_setup": ("K2", "everything after the weight copies and the first cluster barrier", [
        ("  cluster.sync();  // every CTA of the cluster runs before any DSMEM access\n",
         "  cluster.sync();  // every CTA of the cluster runs before any DSMEM access\n"
         "  if (rank >= 0) return;\n")]),
    "k2_nobwd": ("K2", "the backward (its barriers too)", [
        ("    for (int i = n_layers - 1; i >= 0; --i) {\n      const int in = c.dims[i], out = c.dims[i + 1];\n"
         "      if (((2 * i) >> 5) != group) {\n        group = (2 * i) >> 5;\n"
         "        fill_words(words, ws, 1, R,",
         "    for (int i = n_layers - 1; i >= n_layers; --i) {\n      const int in = c.dims[i], out = c.dims[i + 1];\n"
         "      if (((2 * i) >> 5) != group) {\n        group = (2 * i) >> 5;\n"
         "        fill_words(words, ws, 1, R,")]),
    "k2_nopart": ("K2", "the backward's partial sums (not their barriers)", [
        ("      for (int idx = tid; idx < R * (in4 / 4); idx += blockDim.x) {",
         "      for (int idx = tid; idx < 0; idx += blockDim.x) {")]),
    "k2_noleader": ("K2", "CTA 0's loss and output cotangent", [
        ("    if (rank == 0) {\n      const int nq", "    if (rank == 99) {\n      const int nq")]),
    "k2_dsync": ("K2", "nothing: every cluster barrier is doubled", [
        ("cluster.sync();", "cluster.sync(); cluster.sync();")]),
    "k2_cluster_all": ("K2", "nothing: the cluster form at every row count", [
        ("constexpr int kClusterMaxRows = 512;", "constexpr int kClusterMaxRows = 1 << 30;")]),
    "k2_tile_all": ("K2", "nothing: one block per 32-row tile at every row count", [
        ("constexpr int kClusterMaxRows = 512;", "constexpr int kClusterMaxRows = 0;")]),
}


def variant_source(src, subs):
    for old, new in subs:
        if old not in src:
            raise ValueError(f"substitution does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(name, src, out_dir):
    from bayesgm_torch.ops._build import NVCC_FLAGS, _nvcc

    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", so, cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return so


def typed_lib(tk, so):
    """The library at ``so`` with the argument types the wrapper's ``_lib``
    sets on its own."""
    lib = ctypes.CDLL(so)
    saved = tk.load_library
    tk.load_library = lambda source: type("Loaded", (), {"lib": lib})()
    try:
        return tk._lib()
    finally:
        tk.load_library = saved


def device_ms(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if "bnn_hosteps" in e.key)
    return total / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ablate_hosteps: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
    from bayesgm_torch.ops import _pk_bnn_hosteps as tk
    from bayesgm_torch.ops._build import BUILD_DIR
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
        flipout_step_perturbations,
        split_flipout_flat,
    )
    from bayesgm_torch.utils.device import card_info

    with open(SOURCE) as f:
        src = f.read()
    sources = {name: variant_source(src, subs) for name, (_, _, subs) in VARIANTS.items()}
    out_dir = os.path.join(BUILD_DIR.parent, "ablate_hosteps")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor() as pool:
        sos = dict(zip(sources, pool.map(lambda kv: build(kv[0], kv[1], out_dir), sources.items())))

    dev = torch.device("cuda")
    data = Sim_Hirano_Imbens_sampler(batch_size=32, N=N, v_dim=V_DIM, seed=0).load_all()
    with tempfile.TemporaryDirectory() as d:
        model = CausalBGM(dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                               dataset="ablate", output_dir=d, save_res=False,
                               lr_decay="cosine"), random_seed=123, device="cuda")
    cfg, dims = model.cfg, [model.nets[k].dims for k in "ghf"]
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(model.nets[k])) for k in "ghf"))
    sigs = sum(sigs, [])
    x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in data)
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn((N, sum(Z_DIMS)), generator=gen, device=dev)
    seed = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=dev, dtype=torch.int32)
    ps1, ps2 = flipout_step_perturbations(sigs, gen), flipout_step_perturbations(sigs, gen, n_sets=2)
    paired = [torch.cat([a, a]) for a in (z, x, y, v)]
    k1p = tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims, paired=True)
    k2 = tk.make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)

    card = card_info()
    print(card, flush=True)
    libs = {name: typed_lib(tk, so) for name, so in sos.items()}
    real_lib = tk._lib
    try:
        for name in sos:
            tk._lib = lambda _typed=libs[name]: _typed
            probes, drops, _ = VARIANTS[name]
            runs = []
            if "K1" in probes:
                runs.append(("K1 paired", 2 * N, lambda: k1p(*paired, seed, *ws, ps2)))
            if "K2" in probes:
                rows = K2_ROWS if name in ("base", "k2_cluster_all", "k2_tile_all") else (32,)
                for n in rows:
                    a = [t[:n].contiguous() for t in (z, x, y, v)]
                    runs.append(("K2", n, lambda a=a: k2(*a, seed, *ws, ps1)))
            for kernel, n, fn in runs:
                print(json.dumps({"variant": name, "drops": drops, "kernel": kernel, "rows": n,
                                  "device_ms": device_ms(fn, args.reps), "card": card}),
                      flush=True)
    finally:
        tk._lib = real_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
