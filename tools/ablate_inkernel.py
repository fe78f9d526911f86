#!/usr/bin/env python3
"""Where the time of K5, K6, K7, K3 and K4 goes, by ablation, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/ablate_inkernel.py [--reps 20] [--only k5|k7|k3|k4]

It builds variants of ``bayesgm_torch/csrc/bnn_inkernel.cu`` (K5, K6, one
evaluation of K5's device code, and K7's two forms) and
``bayesgm_torch/csrc/plain.cu`` (K3, K4) that each drop or swap one part of
a kernel, or set K4's row tile and weight ring to other sizes, or send every
row count to one of K7's or K3's forms (by a textual substitution, checked
to apply; the switches exist only in these builds, never in the package's
sources), and times every variant's device time per launch
(``chip_smoke.device_ms``: CUDA events around one launch queued behind a
spin kernel) at the main path's shapes: K5's 50-step window and one K6
evaluation over n = 20000 rows with the model's row block (512 at this
width), K7 over n and over fit's 32 rows with its own row block (256), K3
over fit's 32 rows, K7's and K3's forms from 32 to 20000 rows, and K4 over
predict's batch of 10000 rows and n (its tile and ring sweep also over 1000
rows), at the width of the repo's flagship configuration with random
weights from seed 123.  A variant's values are wrong on purpose: only its
time means anything.  Prints one JSON line per measurement and the card's
name and power limit.  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

from chip_smoke import device_ms  # noqa: E402
from tools.ablate_hosteps import build, typed_lib, variant_source  # noqa: E402

N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
K5_STEPS = 50
K3_ROWS = (32, 128, 256, 384, 512, 1024, 20000)
K7_ROWS = (32, 128, 256, 384, 512, 640, 768, 1024, 20000)
K7_FIT_ROWS = 32
K4_ROWS = (10000, 20000)
K4_SWEEP_ROWS = (1000, 10000, 20000)


def k4_geometry(**sizes):
    """Substitutions that set K4's constants: ``Rows`` (the row tile),
    ``Stages`` (the weight ring's slots) and ``MicroRows`` (the rows of a
    thread's micro-tile on a 64-wide panel)."""
    return [(f"constexpr int kK4{name} = ", f"constexpr int kK4{name} = {value}; //")
            for name, value in sizes.items()]


K5_BUILD = ("__device__ void k5_build_p(const Params& p, int pc, float* slot, int half, int blk, "
            "uint32_t ev,\n                           uint2 key) {\n")
K5_COPY = "__device__ void k5_copy_panel(const Params& p, int pc, float* slot, int half) {\n"
K7_BWD_PUSH = "    if (Probe<V>::kK7)\n      for (int i = c.n_layers - 2; i >= 0; --i)"

# name -> (source, kernel it probes, what it drops, [(old, new), ...])
VARIANTS = {
    "k5_base": ("bnn_inkernel.cu", "K5+K6", "nothing", []),
    "k5_noprod": ("bnn_inkernel.cu", "K5+K6", "the products' inner loop", [
        ("#pragma unroll 8\n    for (int k = 0; k < in; ++k) {\n"
         "      const float4 a = load4(act + k * kK5Rows + r0);",
         "#pragma unroll 8\n    for (int k = 0; k < 0; ++k) {\n"
         "      const float4 a = load4(act + k * kK5Rows + r0);"),
        ("#pragma unroll 4\n      for (int k = 0; k < in; ++k) {\n"
         "        const float a = from_op(act[k * kK5Rows + r]);",
         "#pragma unroll 4\n      for (int k = 0; k < 0; ++k) {\n"
         "        const float a = from_op(act[k * kK5Rows + r]);")]),
    "k5_consteps": ("bnn_inkernel.cu", "K5+K6", "the eps draw (Philox and Box-Muller): a constant normal", [
        ("const uint4 w4 = philox4x32_10(eps_counter(blk, qi, ev, q.ch, q.layer), key);",
         "const uint4 w4 = make_uint4(0u, 0u, 0u, (uint32_t)qi);"),
        ("box_muller(m ? w4.z : w4.x, m ? w4.w : w4.y, cs, sn);",
         "cs = 0.5f + (float)(w4.w & 1u);\n      sn = -0.5f;")]),
    "k5_nobuild": ("bnn_inkernel.cu", "K5+K6", "P's build in place (draws and products): P = sigma", [
        (K5_BUILD, K5_BUILD + "  if (pc >= 0) return;\n")]),
    "k5_noload": ("bnn_inkernel.cu", "K5+K6", "the loc, sigma and b panels' copies", [
        (K5_COPY, K5_COPY + "  if (pc >= 0) return;\n")]),
    "k5_nomh": ("bnn_inkernel.cu", "K5", "the proposal and the accept step", [
        ("    for (int idx = tid; idx < R * quads; idx += blockDim.x) {",
         "    for (int idx = tid; idx < 0; idx += blockDim.x) {"),
        ("    if (tid < R) {  // warps 0 and 1, all lanes", "    if (tid < 0) {")]),
    "k7_base": ("bnn_inkernel.cu", "K7", "nothing", []),
    "k7_nobwd": ("bnn_inkernel.cu", "K7", "the backward (the last layer's inside its forward too)", [
        (K7_BWD_PUSH, K7_BWD_PUSH.replace("Probe<V>::kK7", "V < 0")),
        ("    if constexpr (Probe<V>::kK7) k7_backward<V>(p, s, st, ch, cur, group, ev, acc, row0, n_valid);",
         ""),
        ("            __syncthreads();  // the panel's d and d r_out are complete\n"
         "            k7_bwd_panel<true>(p, q, slot, st.half, e.dbuf, e.sbuf, acc);", "")]),
    "k7_nobwdbuild": ("bnn_inkernel.cu", "K7", "P's build for the backward's panels (their P = sigma)", [
        ("      if (g < total) k5_build_p<V>(p, g % NP, slot(g), half, blk, (uint32_t)(g / NP), key);",
         "      if (g < total && !(p.panel[g % NP] >> 15)) "
         "k5_build_p<V>(p, g % NP, slot(g), half, blk, (uint32_t)(g / NP), key);")]),
    "k7_noload": ("bnn_inkernel.cu", "K7", "the loc, sigma and b panels' copies", [
        (K5_COPY, K5_COPY + "  if (pc >= 0) return;\n")]),
    "k7c_nosetup": ("bnn_inkernel.cu", "K7c", "the cluster form's set-up: its slices' copies and P's draws", [
        ("      for (int idx = tid; idx < in4 * ns; idx += blockDim.x) {\n"
         "        const int jl = idx / in4, k = idx - jl * in4;\n        if (k < in) {",
         "      for (int idx = tid; idx < 0; idx += blockDim.x) {\n"
         "        const int jl = idx / in4, k = idx - jl * in4;\n        if (k < in) {")]),
    "k7c_nobwd": ("bnn_inkernel.cu", "K7c", "the cluster form's backward (its barriers too)", [
        ("    // Backward, last layer to first.\n    for (int i = n_layers - 1; i >= 0; --i) {",
         "    // Backward, last layer to first.\n    for (int i = n_layers - 1; i >= n_layers; --i) {")]),
    "k7c_dsync": ("bnn_inkernel.cu", "K7c", "nothing: every cluster barrier is doubled", [
        ("cluster.sync();", "{ cluster.sync(); cluster.sync(); }")]),
    "k7_cluster_all": ("bnn_inkernel.cu", "K7", "nothing: the cluster form at every row count", [
        ("constexpr int kK7ClusterMaxRows = ", "constexpr int kK7ClusterMaxRows = 1 << 30; //")]),
    "k7_tile_all": ("bnn_inkernel.cu", "K7", "nothing: K5's tiles at every row count", [
        ("constexpr int kK7ClusterMaxRows = ", "constexpr int kK7ClusterMaxRows = 0; //")]),
    "k3_base": ("plain.cu", "K3", "nothing", []),
    "k3_nobwd": ("plain.cu", "K3", "the backward (its barriers too)", [
        ("n_pass = max(n_pass, 2 * p.chain[ch].n_layers + 1);",
         "n_pass = max(n_pass, p.chain[ch].n_layers + 1);"),
        ("      } else if (t <= 2 * L) {", "      } else if (t <= 2 * L && t < 0) {")]),
    "k3_dsync": ("plain.cu", "K3", "nothing: every cluster barrier is doubled", [
        ("cluster.sync();", "{ cluster.sync(); cluster.sync(); }")]),
    "k3_cluster_all": ("plain.cu", "K3", "nothing: the cluster form at every row count", [
        ("constexpr int kClusterMaxRows = ", "constexpr int kClusterMaxRows = 1 << 30; //")]),
    "k3_tile_all": ("plain.cu", "K3", "nothing: one block per 32-row tile at every row count", [
        ("constexpr int kClusterMaxRows = ", "constexpr int kClusterMaxRows = 0; //")]),
    "k4_base": ("plain.cu", "K4", "nothing", []),
    "k4_noprod": ("plain.cu", "K4", "the products' inner loop", [
        ("#pragma unroll 8\n    for (int k = 0; k < in; ++k) {\n      float av[MR];",
         "#pragma unroll 8\n    for (int k = 0; k < 0; ++k) {\n      float av[MR];"),
        ("#pragma unroll 4\n      for (int k = 0; k < in; ++k) {\n"
         "        const float a = act[k * R + r];",
         "#pragma unroll 4\n      for (int k = 0; k < 0; ++k) {\n"
         "        const float a = act[k * R + r];")]),
    "k4_noload": ("plain.cu", "K4", "the w and b panels' copies", [
        ("__device__ void issue_panel(const Params& p, int pc, float* slot, int half) {\n",
         "__device__ void issue_panel(const Params& p, int pc, float* slot, int half) {\n"
         "  if (pc >= 0) return;\n")]),
    "k4_noepi": ("plain.cu", "K4", "the 64-wide panels' epilogue (the loss's groups too)", [
        ("    k4_epilogue<R, MR>(e, r0, q.col0 + c0, out, bs + c0, am, tv);",
         "    if (am[0][0] == 1.2345f && am[MR - 1][3] == 3.f) "
         "k4_epilogue<R, MR>(e, r0, q.col0 + c0, out, bs + c0, am, tv);")]),
    "k4_nonarrow": ("plain.cu", "K4", "the narrow panels' inner loop", [
        ("#pragma unroll 4\n      for (int k = 0; k < in; ++k) {\n"
         "        const float a = act[k * R + r];",
         "#pragma unroll 4\n      for (int k = 0; k < 0; ++k) {\n"
         "        const float a = act[k * R + r];")]),
    "k4_gonly": ("plain.cu", "K4", "h's and f's chains", [
        ("  int pc = 0, cur = 0;\n  for (int ch = 0; ch < 3; ++ch) {",
         "  int pc = 0, cur = 0;\n  for (int ch = 0; ch < 1; ++ch) {")]),
}
# K4's row tile, ring and micro-tile (the shipped sizes are k4_base's)
for _rows in (32, 64):
    for _stages in (2, 3):
        for _mr in (2, 4):
            VARIANTS[f"k4_r{_rows}_s{_stages}_m{_mr}"] = (
                "plain.cu", "K4", f"nothing: a {_rows}-row tile, {_stages} ring slots, "
                f"{_mr} x 4 micro-tiles", k4_geometry(Rows=_rows, Stages=_stages, MicroRows=_mr))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=["k5", "k7", "k3", "k4"], default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ablate_inkernel: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
    from bayesgm_torch.ops import _pk_bnn_inkernel as ik
    from bayesgm_torch.ops import _pk_plain as tp
    from bayesgm_torch.ops._build import BUILD_DIR, CSRC
    from bayesgm_torch.ops._pk_util import flatten_flipout_params, flatten_mlp_params
    from bayesgm_torch.utils.device import card_info

    variants = {k: v for k, v in VARIANTS.items() if args.only is None or k.startswith(args.only)}
    srcs = {}
    for name, (source, _, _, subs) in variants.items():
        srcs[name] = variant_source((CSRC / source).read_text(), subs)
    out_dir = os.path.join(BUILD_DIR.parent, "ablate_inkernel")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor() as pool:
        sos = dict(zip(srcs, pool.map(lambda kv: build(kv[0], kv[1], out_dir), srcs.items())))

    dev = torch.device("cuda")
    data = Sim_Hirano_Imbens_sampler(batch_size=32, N=N, v_dim=V_DIM, seed=0).load_all()
    x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in data)
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn((N, sum(Z_DIMS)), generator=gen, device=dev)
    seed = torch.tensor([3, 17], dtype=torch.int32, device=dev)
    q_sd = torch.tensor(1.0, device=dev)
    models = {}
    for bnn in (True, False):
        with tempfile.TemporaryDirectory() as d:
            models[bnn] = CausalBGM(dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                                         dataset="ablate", output_dir=d, use_bnn=bnn,
                                         save_res=False, lr_decay="cosine"),
                                    random_seed=123, device="cuda")
    bm, pm = models[True], models[False]
    k5 = ik.make_fused_mh_steps_bnn(bm.cfg, *[bm.nets[k].dims for k in "ghf"], n_steps=K5_STEPS)
    iflats = [flatten_flipout_params(bm.nets[k]) for k in "ghf"]
    k6 = ik.make_fused_causal_logp_bnn(bm.cfg, *[bm.nets[k].dims for k in "ghf"])
    k7 = ik.make_fused_causal_logp_and_grad_bnn(bm.cfg, *[bm.nets[k].dims for k in "ghf"])
    k3 = tp.make_fused_causal_logp_and_grad(pm.cfg, *[pm.nets[k].dims for k in "ghf"])
    k4 = tp.make_fused_causal_logp(pm.cfg, *[pm.nets[k].dims for k in "ghf"])
    flats = [flatten_mlp_params(pm.nets[k]) for k in "ghf"]

    card = card_info()
    print(card, flush=True)
    saved = {ik: ik._lib, tp: tp._lib}
    try:
        for name, so in sos.items():
            source, probes, drops, _ = variants[name]
            mod = ik if source == "bnn_inkernel.cu" else tp
            typed = typed_lib(mod, so)
            mod._lib = lambda _typed=typed: _typed
            runs = []
            if probes.startswith("K5"):
                runs.append((f"K5 {K5_STEPS} steps block_rows {k5.block_rows}", N, 5,
                             lambda: k5(z, x, y, v, seed, q_sd, *iflats)))
            if probes.endswith("K6"):
                runs.append((f"K6 block_rows {k6.block_rows}", N, args.reps,
                             lambda: k6(z, x, y, v, seed, *iflats)))
            if probes.startswith("K7"):
                if name in ("k7_base", "k7_cluster_all", "k7_tile_all"):
                    rows = K7_ROWS
                else:
                    rows = (K7_FIT_ROWS,) if probes == "K7c" else (N,)
                for n in rows:
                    a = [t[:n].contiguous() for t in (z, x, y, v)]
                    runs.append((f"K7 block_rows {k7.block_rows}", n, args.reps,
                                 lambda a=a: k7(*a, seed, *iflats)))
            if probes == "K4":
                rows = K4_SWEEP_ROWS if name.startswith("k4_r") else K4_ROWS
                for n in rows:
                    a = [t[:n].contiguous() for t in (z, x, y, v)]
                    runs.append(("K4", n, args.reps, lambda a=a: k4(*a, *flats)))
            elif probes == "K3":
                rows = K3_ROWS if name in ("k3_base", "k3_cluster_all", "k3_tile_all") else (32,)
                for n in rows:
                    a = [t[:n].contiguous() for t in (z, x, y, v)]
                    runs.append(("K3", n, args.reps, lambda a=a: k3(*a, *flats)))
            for kernel, n, reps, fn in runs:
                print(json.dumps({"variant": name, "drops": drops, "kernel": kernel, "rows": n,
                                  "device_ms": device_ms(fn, n_warm=2, n_iter=reps),
                                  "card": card}), flush=True)
            mod._lib = saved[mod]
    finally:
        for mod, lib in saved.items():
            mod._lib = lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
