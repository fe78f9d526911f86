// Plain-MLP (use_bnn=False) CausalBGM negative log-posterior (K4), and the
// same value with its z-gradient (K3).
//
// K4 replaces the TPU kernel bayesgm_tpu/ops/_pk_plain.py::
// make_fused_causal_logp, K3 replaces make_fused_causal_logp_and_grad of the
// same file.  Their plain PyTorch versions are bayesgm_torch/ops/_pk_plain.py::
// logp_plain and logp_and_grad_plain (autograd of logp_plain, independent of
// the hand-written backward here).
//
// What they compute, per row: three LeakyReLU(0.2) chains g: z ->
// (mu_v, s_v), h: (z0, z2) -> (mu_x, s_x) and f: (z0, z1, x) -> (mu_y, s_y),
// each h <- h @ w + b per layer with a linear last layer.  The loss is the
// Gaussian NLL of v, x and y (softplus(raw) + 1e-6 variance heads or fixed
// sigmas; Bernoulli logits for a binary treatment) plus the N(0, I) prior
// sum(z^2)/2.  K3 adds the gradient: the output cotangent (-(t - mu) / s on
// the mu columns, dl/ds * sigmoid(raw) on the variance column with
// dl/ds = -sq / (2 s^2) + d / (2 s), 0 there when sigma is fixed;
// sigmoid(lx) - x on a binary treatment's logit), then per layer, last to
// first, cot_in = (cot @ w^T) * leaky'(previous pre-activation).  The
// chain-input gradients land in z: g's on all of z, h's (z0, z2) on [0, d0)
// and [d0 + d1, d0 + d1 + d2), f's (z0, z1) on [0, d0 + d1) (its x column is
// dropped); the prior adds z.
//
// What bounds them on an H100: f32 FMA work, no tensor cores.  At the
// benchmark width (g [10, 64x5, 201], h/f [., 64, 32, 8, 2]) the chains are
// 34,848 multiply-adds per row over ~0.85 KB of row data, ~82 flop/byte, so
// K4 is bound by operations (at n=10000: 0.70 GFLOP, 10.4 us at the 67 TFLOP/s
// f32 peak, against 2.5 us for the bytes).  K3 does about twice the work.  At
// the fit batch of 32 rows (4.5 MFLOP) K3 is bound by latency: 28 layer
// passes in series (g 6 + 6, h 4 + 4, f 4 + 4), and on one block the serial
// walk over the staged layers sets its time, not the arithmetic.
//
// What the design does about it.
// - K4 (plain_logp_kernel): K1's register-tiled design (csrc/bnn_hosteps.cu)
//   without P, the signs and the second product.  A block takes a tile of
//   kK4Rows = 32 rows; activations are kept k-major (act[k][row]); each
//   layer's w and b are cut into panels of at most 64 output columns that
//   stream through a ring of kK4Stages = 3 cp.async slots across layer and
//   chain boundaries (one __syncthreads per panel hands a slot over).  On a
//   64-wide panel each thread computes a micro-tile of kK4MicroRows = 2
//   rows x 4 columns (256 threads per tile), on a narrower one one row x 4
//   columns.  A chain's last layer is never written out:
//   each micro-tile folds its columns into the rows' error groups (K1's
//   order, sq_rows below), mu0 and the variance head, with the targets
//   loaded before the products.  Shared memory at the benchmark width: 16 KB
//   of activations, 3 x 16.6 KB of slots, 6.4 KB of error groups (~73 KB):
//   three blocks per SM, so 10000 rows (313 tiles) run in one round on 132
//   SMs.  tools/ablate_inkernel.py sweeps the sizes (32 and 64 rows, 2 and
//   3 slots, 2 x 4 and 4 x 4 micro-tiles): at 10000 rows the 32-row cells
//   take 0.067-0.068 ms, the 64-row ones 0.072-0.082; 2 x 4 is the fastest
//   lone tile (1000 rows: 0.044 ms against 0.051 for 4 x 4) and at 20000
//   rows (0.113 against 0.119-0.127).
// - K3 past kClusterMaxRows rows (plain_grad_kernel): one block of 8 warps
//   takes 32 rows; each warp owns 4 rows and walks the output columns with
//   its 32 lanes, each layer's w and b staged in shared memory once per
//   tile.  It keeps every hidden pre-activation and the last layer's output
//   in shared memory, holds the cotangent in two ping-pong buffers and
//   stages each layer's w again for the backward with an odd row stride
//   (out | 1), so the 32 lanes walking the input columns hit 32 banks
//   (~152 KB at the benchmark width).
// - K3 up to kClusterMaxRows rows (plain_grad_cluster_kernel; the fit batch
//   of 32 rows is one tile): K2's cluster form (csrc/bnn_hosteps.cu) without
//   P and the signs, with the three chains in lockstep and a backward built
//   like the forward.  A 32-row tile is spread over a cluster of 8 CTAs.
//   CTA c owns a slice of every layer's output columns and one of its input
//   rows (c * width / 8 up to (c + 1) * width / 8) and copies, once, with
//   cp.async, its column slice of every layer's w (transposed, [col][k])
//   and b for the forward and its row slice of w for the backward (~34 KB
//   for all three chains at the benchmark width).  A chain of L layers
//   takes 2L + 1 steps, each ending with one cluster.sync: forward layer s
//   (each output of the CTA's columns written into every CTA's next buffer
//   through DSMEM, the last layer's too); the rows' loss and the output
//   cotangent on every CTA, from the tile's v, x and y copied in at the
//   start; backward layer 2L - s, where each CTA forms the cotangent of its
//   own inputs, a dot over all the layer's outputs, and writes it into every
//   CTA's next buffer (the chain input's into CTA 0's dz).  No partial sums
//   cross CTAs and nothing is added with atomics: two launches give the
//   same bits.  g, h and f take their steps side by side: 14 cluster
//   barriers at the benchmark width where one chain after another needs
//   32.  ~154 KB of shared memory per CTA at the benchmark width.
// - K3 = K4 bit for bit in both forms: every output is an fmaf chain over
//   ascending k from 0 plus b, a row's squared error is summed in K4's
//   order (K1's: groups of 4 columns, then the groups in ascending order;
//   sq_rows forms K3's groups across the block and adds each row's in one
//   thread), and the row's value adds head_nll for g, h, f and then the
//   prior, as K4 does.
// A shape whose buffers do not fit in 227 KB returns kErrSmem.
// What is left (NVIDIA H100 80GB HBM3, 700 W; tools/ablate_inkernel.py and
// chip_smoke.py; PERF.md section 6): K4 takes ~0.067 ms of device time at
// 10000 rows (15 % of its bound) and ~0.113 at 20000; a lone tile (1000
// rows) takes ~0.044 ms, so at 10000 rows, 2 to 3 tiles per SM, the
// tiles' latency sets the time: without the products'
// inner loop 0.040, without the weight copies 0.058, without the narrow
// panels' loop 0.062, without the 64-wide epilogue 0.064, g's chain alone
// 0.053.  K3's cluster form takes ~0.052 ms of device time at 32 rows and
// up to 384 rows, 0.10 ms at 512 (16 clusters no longer run at once);
// without the backward ~0.04; each of
// the 14 cluster barriers costs ~0.4 us alone; launch and weight copies
// ~0.008.  One block per tile takes ~0.12 ms up to 1024 rows (0.13 for the
// cluster form there) and 0.62 ms at 20000.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 20;  // per chain
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most one block may use
constexpr float kLeakySlope = 0.2f;
constexpr float kEpsF = 1e-6f;

// K4's row tile and the slots of its weight ring (tools/ablate_inkernel.py
// sweeps both; see the top of this file), and its weight panels: at most 64
// output columns each, at most kMaxPanels in all.
constexpr int kK4Rows = 32;
constexpr int kK4Stages = 3;
// Rows of a thread's micro-tile on a 64-wide panel (2 or 4) x 4 columns.
constexpr int kK4MicroRows = 2;
constexpr int kPanelCols = 64;
constexpr int kMaxPanels = 256;

constexpr int kCluster = 8;  // K3's CTAs per row tile in its cluster form
// K3 takes the cluster form up to this many rows; past it, one block per
// 32-row tile is faster (tools/ablate_inkernel.py times both forms).
constexpr int kClusterMaxRows = 512;

// Error codes of the host functions beside cudaError_t (which is >= 0).
constexpr int kErrTooManyLayers = -1;
constexpr int kErrSmem = -2;
constexpr int kErrShape = -3;

struct Chain {
  int n_layers;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];  // (in, out), row-major
  const float* b[kMaxLayers];  // (out,)
  int pre_off[kMaxLayers];     // K3: column of hidden layer i's pre-activations
};

struct Params {
  Chain chain[3];
  const float* z;
  const float* x;
  const float* y;
  const float* v;
  float* out;
  float* grad;  // K3 only: (n_rows, z_dim)
  int n_rows, z_dim, v_dim, d0, d1, d2;
  int binary;
  int fixed_mask;  // bit 0: sigma_v fixed, bit 1: sigma_x, bit 2: sigma_y
  float sigma_v, sigma_x, sigma_y;
  int width;       // max over chains of any layer width (K3's cotangent stride)
  int act_stride;  // max over chains of a layer's input width
  int w_max;       // max over layers of in * out
  int wt_max;      // max over layers of in * (out | 1)
  int b_max;       // max over layers of out
  int pre_stride;  // K3: max over chains of the summed hidden widths
  // K3's cluster form: the largest per-CTA weight slices (floats) over the
  // 8 CTAs, and per chain the offsets (floats) of its act, pre, full, dz and
  // loss buffers and act's column stride; then the tile's v, x and y,
  // sq / s_row / c_var, and the end of the floats
  int k3_w, k3_off[3][5], k3_as[3], k3_vt, k3_misc, k3_floats;
  // K4: error groups per row (ceil(v_dim / 4)), its weight panels in the
  // order a tile walks them (chain << 12 | layer << 6 | panel) and the
  // ring's slots
  int n_groups, n_panels, n_stages;
  uint16_t panel[kMaxPanels];
};

__device__ __forceinline__ float softplus(float r) {
  return fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
}

__device__ __forceinline__ float sigmoid(float r) { return 1.f / (1.f + expf(-r)); }

__device__ __forceinline__ float leaky(float h) { return h > 0.f ? h : kLeakySlope * h; }

// Column k of chain ch's input for a row: g takes z, h takes (z0, z2), f
// takes (z0, z1, x).
__device__ __forceinline__ float chain_input(const Params& p, int ch, int row, int k) {
  if (ch == 0) return p.z[row * p.z_dim + k];
  if (ch == 1) return p.z[row * p.z_dim + (k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0))];
  return k < p.d0 + p.d1 ? p.z[row * p.z_dim + k] : p.x[row];
}

// Column col of chain ch's target: v for g, x for h, y for f.
__device__ __forceinline__ float target(const Params& p, int ch, int row, int col) {
  return ch == 0 ? p.v[row * p.v_dim + col] : (ch == 1 ? p.x[row] : p.y[row]);
}

__device__ __forceinline__ bool sigma_fixed(const Params& p, int ch) {
  return (p.fixed_mask >> ch) & 1;
}

// Chain ch's head variance for a row: the fixed sigma^2, or softplus(raw) + 1e-6.
__device__ __forceinline__ float head_var(const Params& p, int ch, float raw) {
  if (sigma_fixed(p, ch)) {
    const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
    return sigma * sigma;
  }
  return softplus(raw) + kEpsF;
}

// Chain ch's term of a row's loss from its squared error sq, its first
// output mu0 and its variance column raw.
__device__ __forceinline__ float head_nll(const Params& p, int ch, int row, float sq, float mu0,
                                          float raw) {
  if (ch == 1 && p.binary) return fmaxf(mu0, 0.f) - mu0 * p.x[row] + log1pf(expf(-fabsf(mu0)));
  const float s = head_var(p, ch, raw);
  const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
  return sq / (2.f * s) + n_dims * logf(s) / 2.f;
}

__device__ __forceinline__ float prior_half_sq(const Params& p, int row) {
  float zz = 0.f;
  for (int k = 0; k < p.z_dim; ++k) {
    const float zk = p.z[row * p.z_dim + k];
    zz = fmaf(zk, zk, zz);
  }
  return zz / 2.f;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The squared errors sq[r] of the tile's R rows over their d_mu mu columns
// (diff(r, col) = target - output; 0 for rows from n_valid on) in K1's order
// (csrc/bnn_hosteps.cu): group q, columns 4q .. 4q+3 below d_mu, is an fmaf
// chain over its columns in ascending order, and a row's sum adds its
// groups in ascending q from 0.  K4 forms the groups in its micro-tiles'
// epilogue; K3 repeats the order here: the block's threads form every
// row's groups into groups[r * n_groups + q] (r fastest, so that
// neighbouring threads read neighbouring rows), then thread r adds its
// row's.  Call from every thread; the first barrier is inside, the caller
// puts one after.
template <int R, class Diff>
__device__ __forceinline__ void sq_rows(int d_mu, int n_valid, int n_groups, float* groups,
                                        float* sq, Diff diff) {
  const int nq = (d_mu + 3) / 4;
  for (int idx = threadIdx.x; idx < R * nq; idx += blockDim.x) {
    const int q = idx / R, r = idx - q * R;
    float g = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * q + j < d_mu) {
        const float d = diff(r, 4 * q + j);
        g = fmaf(d, d, g);
      }
    }
    groups[r * n_groups + q] = g;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += groups[r * n_groups + q];
    sq[r] = r < n_valid ? s : 0.f;
  }
}

// ---------------------------------------------------------------- K4 ----

// A panel of K4's weight stream: out columns col0 .. col0 + ncols - 1 of one
// layer, padded to width (a multiple of 4) with zeros in shared memory.
struct Panel {
  int ch, layer, col0, ncols, width;
};

__device__ __forceinline__ Panel panel_at(const Params& p, int pc) {
  Panel q;
  const int code = p.panel[pc];
  q.ch = code >> 12;
  q.layer = (code >> 6) & 63;
  q.col0 = (code & 63) * kPanelCols;
  const int out = p.chain[q.ch].dims[q.layer + 1];
  q.ncols = min(kPanelCols, out - q.col0);
  q.width = (q.ncols + 3) & ~3;
  return q;
}

// A slot holds one panel: w[k][width], then b[width] at `half` floats.
__device__ void issue_panel(const Params& p, int pc, float* slot, int half) {
  const Panel q = panel_at(p, pc);
  const Chain& c = p.chain[q.ch];
  const int in = c.dims[q.layer], out = c.dims[q.layer + 1];
  const float* w = c.w[q.layer] + q.col0;
  const float* b = c.b[q.layer] + q.col0;
  float* bs = slot + half;
  const int wd = q.width;
  // (k, column) of a thread's element, stepped by blockDim.x elements
  // without a division per element
  if (out % 4 == 0 && aligned16(w)) {
    const int w4 = wd / 4, dk = blockDim.x / w4, dc = blockDim.x - dk * w4;
    int k = threadIdx.x / w4, cc = threadIdx.x - k * w4;
    for (; k < in; k += dk, cc += dc) {
      if (cc >= w4) {
        cc -= w4;
        ++k;
        if (k >= in) break;
      }
      cp_async16(slot + k * wd + 4 * cc, w + (size_t)k * out + 4 * cc);
    }
  } else {
    const int dk = blockDim.x / wd, dc = blockDim.x - dk * wd;
    int k = threadIdx.x / wd, cc = threadIdx.x - k * wd;
    for (; k < in; k += dk, cc += dc) {
      if (cc >= wd) {
        cc -= wd;
        ++k;
        if (k >= in) break;
      }
      if (cc < q.ncols) {
        cp_async4(slot + k * wd + cc, w + (size_t)k * out + cc);
      } else {
        slot[k * wd + cc] = 0.f;
      }
    }
  }
  for (int cc = threadIdx.x; cc < wd; cc += blockDim.x) {
    if (cc < q.ncols) {
      cp_async4(bs + cc, b + cc);
    } else {
      bs[cc] = 0.f;
    }
  }
}

// What a panel's epilogue needs besides the accumulators.
struct Epi {
  float* nact;    // next layer's activations [col][row], or null on the last layer
  float* groups;  // last layer: error groups [row][q]
  float* mu0;
  float* raw;
  int ch, row0, n_valid, d_mu, n_groups;
};

// A last layer's targets for a micro-tile of NR rows and columns col ..
// col + 3, loaded before its products so that their latency hides behind
// them (0 past d_mu and for rows past the tile's end).
template <int NR>
__device__ __forceinline__ void k4_targets(const Params& p, const Epi& e, int r0, int col,
                                           float (&tv)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = e.row0 + r0 + i;
    const bool load = e.nact == nullptr && r0 + i < e.n_valid;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tv[i][j] = load && col + j < e.d_mu ? target(p, e.ch, row, col + j) : 0.f;
  }
}

// A micro-tile of NR rows r0 .. r0 + NR - 1 (R rows in the tile) and four
// columns col .. col + 3 (those < out): am their products, bias the
// panel's b there.  A hidden layer writes LeakyReLU of each output to the
// next layer's activations; the last layer writes the rows' error group
// col / 4, mu0 and the variance head's raw output.
template <int R, int NR>
__device__ __forceinline__ void k4_epilogue(const Epi& e, int r0, int col, int out,
                                            const float* bias, const float (&am)[NR][4],
                                            const float (&tv)[NR][4]) {
  float pre[NR][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float h[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      pre[i][j] = am[i][j] + bias[j];
      h[i] = leaky(pre[i][j]);
    }
    if (e.nact != nullptr && col + j < out) {
      float* na = e.nact + (col + j) * R + r0;
      if constexpr (NR == 4) {
        *reinterpret_cast<float4*>(na) = make_float4(h[0], h[1], h[2], h[3]);
      } else if constexpr (NR == 2) {
        *reinterpret_cast<float2*>(na) = make_float2(h[0], h[1]);
      } else {
        na[0] = h[0];
      }
    }
  }
  if (e.nact != nullptr) return;
  const int q = col / 4, n = e.d_mu - 4 * q;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r0 + i;
    if (r >= e.n_valid) continue;
    if (n > 0) {
      float g = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < n) {
          const float d = tv[i][j] - pre[i][j];
          g = fmaf(d, d, g);
        }
      }
      e.groups[r * e.n_groups + q] = g;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j == 0) e.mu0[r] = pre[i][j];
      if (col + j == e.d_mu && col + j < out) e.raw[r] = pre[i][j];
    }
  }
}

// One panel of one layer for the tile's R rows, from act [k][row] and the
// panel's slot: MR x 4 micro-tiles on a 64-wide panel, one row x 4 columns
// on a narrower one.
template <int R, int MR>
__device__ __forceinline__ void k4_panel(const Params& p, const Epi& e, const Panel& q,
                                         const float* act, const float* slot, int half) {
  const int in = p.chain[q.ch].dims[q.layer], out = p.chain[q.ch].dims[q.layer + 1];
  const int wd = q.width;
  const float* bs = slot + half;
  const int tid = threadIdx.x;
  if (wd == kPanelCols) {
    // A warp covers 32 rows x 4 MR columns: warp -> (32-row part
    // warp % (R / 32), column block warp / (R / 32)), lane -> (row group
    // lane % (32 / MR), column quad lane / (32 / MR)); the lanes of a column
    // quad read 128 contiguous bytes of activations.
    constexpr int kParts = R / 32, kLanesPerCol = 32 / MR;
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = 32 * (warp % kParts) + MR * (lane % kLanesPerCol);
    const int c0 = 4 * MR * (warp / kParts) + 4 * (lane / kLanesPerCol);
    float am[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) am[i][j] = 0.f;
    float tv[MR][4];
    k4_targets<MR>(p, e, r0, q.col0 + c0, tv);
#pragma unroll 8
    for (int k = 0; k < in; ++k) {
      float av[MR];
      if constexpr (MR == 4) {
        const float4 a = *reinterpret_cast<const float4*>(act + k * R + r0);
        av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(act + k * R + r0);
        av[0] = a.x, av[1] = a.y;
      }
      const float4 l = *reinterpret_cast<const float4*>(slot + k * kPanelCols + c0);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) am[i][j] = fmaf(av[i], lv[j], am[i][j]);
    }
    k4_epilogue<R, MR>(e, r0, q.col0 + c0, out, bs + c0, am, tv);
  } else {
    // One row x 4 columns per thread; a warp takes 32 rows of one column quad.
    const int n_quads = wd / 4;
    for (int t = tid; t < R * n_quads; t += blockDim.x) {
      const int r = t % R, c0 = 4 * (t / R);
      float am[1][4] = {{0.f, 0.f, 0.f, 0.f}}, tv[1][4];
      k4_targets<1>(p, e, r, q.col0 + c0, tv);
#pragma unroll 4
      for (int k = 0; k < in; ++k) {
        const float a = act[k * R + r];
        const float4 l = *reinterpret_cast<const float4*>(slot + k * wd + c0);
        am[0][0] = fmaf(a, l.x, am[0][0]);
        am[0][1] = fmaf(a, l.y, am[0][1]);
        am[0][2] = fmaf(a, l.z, am[0][2]);
        am[0][3] = fmaf(a, l.w, am[0][3]);
      }
      k4_epilogue<R, 1>(e, r, q.col0 + c0, out, bs + c0, am, tv);
    }
  }
}

// K4: one block of 16 R / MR threads per tile of R rows (see the top of
// this file).
template <int R, int MR>
__global__ void __launch_bounds__(16 * R / MR) plain_logp_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int as = p.act_stride;
  const int half = as * kPanelCols;
  const int slot_floats = half + kPanelCols;
  float* act_buf = smem;  // act[0], act[1], each [k][R]
  float* ring = act_buf + 2 * R * as;
  float* groups = ring + p.n_stages * slot_floats;
  float* loss = groups + R * p.n_groups;
  float* mu0 = loss + R;
  float* raw = mu0 + R;

  const int row0 = blockIdx.x * R;
  const int n_valid = min(R, p.n_rows - row0);
  const int tid = threadIdx.x;
  const int S = p.n_stages;
  if (tid < R) loss[tid] = 0.f;

  // Prologue: the first S - 1 panels in flight.
  for (int pc = 0; pc < S - 1; ++pc) {
    if (pc < p.n_panels) issue_panel(p, pc, ring + pc * slot_floats, half);
    cp_async_commit();
  }

  int pc = 0, cur = 0;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const int in0 = c.dims[0];
    float* act = act_buf + cur * R * as;
    for (int idx = tid; idx < R * in0; idx += blockDim.x) {
      const int k = idx / R, r = idx - k * R;
      act[idx] = r < n_valid ? chain_input(p, ch, row0 + r, k) : 0.f;
    }
    Epi e;
    e.groups = groups;
    e.mu0 = mu0;
    e.raw = raw;
    e.ch = ch;
    e.row0 = row0;
    e.n_valid = n_valid;
    e.d_mu = ch == 0 ? p.v_dim : 1;
    e.n_groups = p.n_groups;
    for (int i = 0; i < c.n_layers; ++i) {
      const bool last = i == c.n_layers - 1;
      const float* a = act_buf + cur * R * as;
      e.nact = last ? nullptr : act_buf + (cur ^ 1) * R * as;
      const int n_pan = (c.dims[i + 1] + kPanelCols - 1) / kPanelCols;
      for (int j = 0; j < n_pan; ++j, ++pc) {
        if (S == 3) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // panel pc and the layer's input are ready; slot (pc - 1) % S is free
        const int next = pc + S - 1;
        if (next < p.n_panels) issue_panel(p, next, ring + (next % S) * slot_floats, half);
        cp_async_commit();
        k4_panel<R, MR>(p, e, panel_at(p, pc), a, ring + (pc % S) * slot_floats, half);
      }
      if (!last) cur ^= 1;
    }
    __syncthreads();  // the chain's error groups, mu0 and raw are complete
    if (tid < n_valid) {
      float sq = 0.f;
      for (int q = 0; q < (e.d_mu + 3) / 4; ++q) sq += groups[tid * p.n_groups + q];
      loss[tid] += head_nll(p, ch, row0 + tid, sq, mu0[tid], raw[tid]);
    }
    __syncthreads();  // before the next chain overwrites the groups and its input
  }
  cp_async_wait<0>();
  if (tid < n_valid) p.out[row0 + tid] = loss[tid] + prior_half_sq(p, row0 + tid);
}

// K3.
__global__ void __launch_bounds__(kThreads)
plain_grad_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ws = p.width, as = p.act_stride, ps = p.pre_stride;
  float* pre = smem;                  // hidden pre-activations, stride ps
  float* cot = pre + kTileRows * ps;  // last layer's output, then cotangents; stride ws
  float* uni = cot + kTileRows * ws;  // forward: activations (stride as); backward: cotangents
  float* wl = uni + kTileRows * ws;
  float* wb = wl + p.wt_max;
  float* dz = wb + p.b_max;
  float* loss = dz + kTileRows * p.z_dim;
  float* sq = loss + kTileRows;
  float* s_row = sq + kTileRows;
  float* c_var = s_row + kTileRows;
  float* groups = c_var + kTileRows;  // the rows' error groups [row][q]

  const int row0 = blockIdx.x * kTileRows;
  const int n_valid = min(kTileRows, p.n_rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int idx = tid; idx < kTileRows * p.z_dim; idx += blockDim.x) dz[idx] = 0.f;
  if (tid < kTileRows) loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const int n_layers = c.n_layers;
    float* act = uni;
    const int in0 = c.dims[0];
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      act[r * as + k] = r < n_valid ? chain_input(p, ch, row0 + r, k) : 0.f;
    }

    // Forward, keeping the pre-activations.
    for (int i = 0; i < n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == n_layers - 1;
      __syncthreads();
      if (i > 0) {
        for (int idx = tid; idx < kTileRows * in; idx += blockDim.x) {
          const int r = idx / in, k = idx - r * in;
          act[r * as + k] = leaky(pre[r * ps + c.pre_off[i - 1] + k]);
        }
      }
      const float* w = c.w[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) wl[idx] = w[idx];
      for (int idx = tid; idx < out; idx += blockDim.x) wb[idx] = c.b[i][idx];
      __syncthreads();

      float* dst = last ? cot : pre + c.pre_off[i];
      const int dst_stride = last ? ws : ps;
      for (int col = lane; col < out; col += 32) {
        float am[kRowsPerWarp];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) am[j] = 0.f;
        for (int k = 0; k < in; ++k) {
          const float l = wl[k * out + col];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j)
            am[j] = fmaf(act[(warp * kRowsPerWarp + j) * as + k], l, am[j]);
        }
        const float bc = wb[col];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j)
          dst[(warp * kRowsPerWarp + j) * dst_stride + col] = am[j] + bc;
      }
    }
    __syncthreads();

    // The chain's likelihood term and its output cotangent.  The squared
    // error is summed as K4 sums it (sq_rows).
    const int d_mu = ch == 0 ? p.v_dim : 1;
    const int out_last = c.dims[n_layers];
    sq_rows<kTileRows>(d_mu, n_valid, p.n_groups, groups, sq, [&](int r, int col) {
      return r < n_valid ? target(p, ch, row0 + r, col) - cot[r * ws + col] : 0.f;
    });
    __syncthreads();
    const bool binary_head = ch == 1 && p.binary;
    if (tid < kTileRows) {
      float s = 1.f, cv = 0.f;
      if (tid < n_valid) {
        const int row = row0 + tid;
        const float mu = cot[tid * ws], raw = cot[tid * ws + d_mu];
        loss[tid] += head_nll(p, ch, row, sq[tid], mu, raw);
        if (binary_head) {
          cv = sigmoid(mu) - p.x[row];
        } else {
          s = head_var(p, ch, raw);
          const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
          if (!sigma_fixed(p, ch))
            cv = (-sq[tid] / (2.f * (s * s)) + n_dims / (2.f * s)) * sigmoid(raw);
        }
      }
      s_row[tid] = s;
      c_var[tid] = cv;
    }
    __syncthreads();
    for (int idx = tid; idx < kTileRows * out_last; idx += blockDim.x) {
      const int r = idx / out_last, col = idx - r * out_last;
      float cval = 0.f;
      if (r < n_valid) {
        if (binary_head) {
          cval = col == 0 ? c_var[r] : 0.f;
        } else if (col < d_mu) {
          cval = -(target(p, ch, row0 + r, col) - cot[r * ws + col]) / s_row[r];
        } else if (col == d_mu) {
          cval = c_var[r];
        }
      }
      cot[r * ws + col] = cval;
    }

    // Backward, last layer to first.
    float* cur = cot;
    float* nb = uni;
    for (int i = n_layers - 1; i >= 0; --i) {
      const int in = c.dims[i], out = c.dims[i + 1], ostr = out | 1;
      __syncthreads();
      const float* w = c.w[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) {
        const int k = idx / out, j = idx - k * out;
        wl[k * ostr + j] = w[idx];
      }
      __syncthreads();
      for (int k = lane; k < in; k += 32) {
        float g[kRowsPerWarp];
#pragma unroll
        for (int jj = 0; jj < kRowsPerWarp; ++jj) g[jj] = 0.f;
        for (int j = 0; j < out; ++j) {
          const float l = wl[k * ostr + j];
#pragma unroll
          for (int jj = 0; jj < kRowsPerWarp; ++jj)
            g[jj] = fmaf(cur[(warp * kRowsPerWarp + jj) * ws + j], l, g[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < kRowsPerWarp; ++jj) {
          const int r = warp * kRowsPerWarp + jj;
          float gk = g[jj];
          if (i > 0) gk *= pre[r * ps + c.pre_off[i - 1] + k] > 0.f ? 1.f : kLeakySlope;
          nb[r * ws + k] = gk;
        }
      }
      float* t = cur;
      cur = nb;
      nb = t;
    }
    __syncthreads();

    // Scatter the chain-input gradient into dz.
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      if (r >= n_valid) continue;
      int col = k;
      if (ch == 1) {
        col = k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0);
      } else if (ch == 2 && k >= p.d0 + p.d1) {
        continue;  // f's x column
      }
      dz[r * p.z_dim + col] += cur[r * ws + k];
    }
    __syncthreads();
  }

  if (tid < n_valid) p.out[row0 + tid] = loss[tid] + prior_half_sq(p, row0 + tid);
  for (int idx = tid; idx < kTileRows * p.z_dim; idx += blockDim.x) {
    const int r = idx / p.z_dim;
    if (r < n_valid) {
      const int g_idx = (row0 + r) * p.z_dim + (idx - r * p.z_dim);
      p.grad[g_idx] = dz[idx] + p.z[g_idx];
    }
  }
}

// K3's cluster form (see the top of this file): one 32-row tile over a
// cluster of 8 CTAs, the three chains in lockstep.
__device__ __forceinline__ int slice_start(int width, int c) { return width * c / kCluster; }

// One chain's buffers in a CTA of the cluster form (offsets in Params).
struct K3Chain {
  float* act;   // 2 x [k][row]: forward layer i reads buffer i & 1; then the backward's cotangents
  float* pre;   // own hidden pre-activations, [layer slice][col][row]
  float* full;  // the last layer, then its cotangent [col][row]
  float* dz;    // CTA 0: the chain's input gradient [row][z col]
  float* loss;  // CTA 0: the chain's likelihood term per row
  int as;       // act's column stride
};

__device__ __forceinline__ K3Chain k3_chain(const Params& p, float* smem, int ch) {
  K3Chain b;
  b.act = smem + p.k3_off[ch][0];
  b.pre = smem + p.k3_off[ch][1];
  b.full = smem + p.k3_off[ch][2];
  b.dz = smem + p.k3_off[ch][3];
  b.loss = smem + p.k3_off[ch][4];
  b.as = p.k3_as[ch];
  return b;
}

// sum_k a[k * R + r] * w[k] over k < n, an fmaf chain in ascending k from
// 0 (w 16-byte aligned, padded to a multiple of 4).
__device__ __forceinline__ float dot_rows(const float* a, int r, const float* w, int n) {
  constexpr int R = kTileRows;
  float acc = 0.f;
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    const float4 l = *reinterpret_cast<const float4*>(w + k);
    acc = fmaf(a[k * R + r], l.x, acc);
    acc = fmaf(a[(k + 1) * R + r], l.y, acc);
    acc = fmaf(a[(k + 2) * R + r], l.z, acc);
    acc = fmaf(a[(k + 3) * R + r], l.w, acc);
  }
  for (; k < n; ++k) acc = fmaf(a[k * R + r], w[k], acc);
  return acc;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
plain_grad_cluster_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int R = kTileRows;
  const int rank = (int)cluster.block_rank();
  float* W = smem;  // own slices: per layer w^T [out col][k] and b, then w [in row][col]
  float* vt = smem + p.k3_vt;  // the tile's v [row][col], x and y
  float* xt = vt + R * p.v_dim;
  float* yt = xt + R;
  float* sq = smem + p.k3_misc;
  float* s_row = sq + R;
  float* c_var = s_row + R;
  float* groups = c_var + R;  // the rows' error groups [row][q]
  int* woff = reinterpret_cast<int*>(smem + p.k3_floats);  // [ch * kMaxLayers + i]
  int* boff = woff + 3 * kMaxLayers;
  int* poff = boff + 3 * kMaxLayers;

  const int tile = blockIdx.x / kCluster;
  const int row0 = tile * R;
  const int n_valid = min(R, p.n_rows - row0);
  const int tid = threadIdx.x;

  // Resident weights, all chains: this CTA's column slice of every layer
  // (the forward's) and its row slice (the backward's).
  if (tid == 0) {
    int w = 0;
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      int pr = 0;
      for (int i = 0; i < c.n_layers; ++i) {
        const int in = c.dims[i], out = c.dims[i + 1];
        const int ns = slice_start(out, rank + 1) - slice_start(out, rank);
        const int nk = slice_start(in, rank + 1) - slice_start(in, rank);
        woff[ch * kMaxLayers + i] = w;
        w += ((((in + 3) & ~3) + 1) * ns + 3) & ~3;  // 16-byte aligned blocks
        boff[ch * kMaxLayers + i] = w;
        w += nk * ((out + 3) & ~3);
        poff[ch * kMaxLayers + i] = pr;
        pr += R * ns;
      }
    }
  }
  __syncthreads();
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    for (int i = 0; i < c.n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1], in4 = (in + 3) & ~3, out4 = (out + 3) & ~3;
      const int j0 = slice_start(out, rank), ns = slice_start(out, rank + 1) - j0;
      const int k0 = slice_start(in, rank), nk = slice_start(in, rank + 1) - k0;
      float* wl = W + woff[ch * kMaxLayers + i];
      float* wb = wl + in4 * ns;
      float* wr = W + boff[ch * kMaxLayers + i];
      for (int idx = tid; idx < in4 * ns; idx += blockDim.x) {
        const int jl = idx / in4, k = idx - jl * in4;
        if (k < in) {
          cp_async4(wl + idx, c.w[i] + (size_t)k * out + j0 + jl);
        } else {
          wl[idx] = 0.f;
        }
      }
      for (int jl = tid; jl < ns; jl += blockDim.x) cp_async4(wb + jl, c.b[i] + j0 + jl);
      for (int idx = tid; idx < nk * out4; idx += blockDim.x) {
        const int kl = idx / out4, j = idx - kl * out4;
        if (j < out) {
          cp_async4(wr + idx, c.w[i] + (size_t)(k0 + kl) * out + j);
        } else {
          wr[idx] = 0.f;
        }
      }
    }
  }
  for (int idx = tid; idx < n_valid * p.v_dim; idx += blockDim.x)
    cp_async4(vt + idx, p.v + (size_t)row0 * p.v_dim + idx);
  if (tid < n_valid) {
    cp_async4(xt + tid, p.x + row0 + tid);
    cp_async4(yt + tid, p.y + row0 + tid);
  }
  if (rank == 0) {
    for (int ch = 0; ch < 3; ++ch) {
      float* dz = k3_chain(p, smem, ch).dz;
      for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) dz[idx] = 0.f;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  cluster.sync();  // every CTA of the cluster runs before any DSMEM access

  // Chain ch (L layers) walks steps 0 .. 2L, one per pass, each ending with
  // one cluster barrier: forward layer s (s < L; each output to every CTA's
  // next buffer, the last layer to every CTA's full), the rows' loss and the
  // output cotangent in place in full (s = L, every CTA), and backward
  // layer 2L - s (L < s <= 2L): the CTA's own inputs' cotangent, a dot over
  // all the layer's outputs with its row slice of w, to every CTA's next
  // buffer (the chain input's to CTA 0's dz).
  int n_pass = 0;
  for (int ch = 0; ch < 3; ++ch) n_pass = max(n_pass, 2 * p.chain[ch].n_layers + 1);
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const K3Chain b = k3_chain(p, smem, ch);
    for (int idx = tid; idx < R * c.dims[0]; idx += blockDim.x) {
      const int k = idx / R, r = idx - k * R;
      b.act[idx] = r < n_valid ? chain_input(p, ch, row0 + r, k) : 0.f;
    }
  }
  __syncthreads();
  for (int t = 0; t < n_pass; ++t) {
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      const K3Chain b = k3_chain(p, smem, ch);
      const int L = c.n_layers;
      if (t < L) {
        // Forward layer t: K4's order per output (an fmaf chain over
        // ascending k, then + b).
        const int i = t;
        const int in = c.dims[i], out = c.dims[i + 1];
        const bool last = i == L - 1;
        const int j0 = slice_start(out, rank), ns = slice_start(out, rank + 1) - j0;
        const int in4 = (in + 3) & ~3;
        const float* wl = W + woff[ch * kMaxLayers + i];
        const float* wb = wl + in4 * ns;
        const float* a = b.act + (i & 1) * R * b.as;
        float* dst = last ? b.full : b.act + ((i + 1) & 1) * R * b.as;
        float* pr = b.pre + poff[ch * kMaxLayers + i];
        for (int idx = tid; idx < R * ns; idx += blockDim.x) {
          const int jl = idx / R, r = idx - jl * R, j = j0 + jl;
          const float v = dot_rows(a, r, wl + jl * in4, in) + wb[jl];
          if (!last) pr[idx] = v;
          const float h = last ? v : leaky(v);
          for (int cc = 0; cc < kCluster; ++cc) cluster.map_shared_rank(dst, cc)[j * R + r] = h;
        }
      } else if (t == L) {
        // Every CTA: the rows' likelihood terms (kept by CTA 0) and the
        // output cotangent, in place of the last layer.
        const int d_mu = ch == 0 ? p.v_dim : 1;
        const int out_last = c.dims[L];
        const bool binary_head = ch == 1 && p.binary;
        float* full = b.full;
        auto tgt = [&](int r, int col) {
          return ch == 0 ? vt[r * p.v_dim + col] : (ch == 1 ? xt[r] : yt[r]);
        };
        sq_rows<R>(d_mu, n_valid, p.n_groups, groups, sq, [&](int r, int col) {
          return r < n_valid ? tgt(r, col) - full[col * R + r] : 0.f;
        });
        __syncthreads();
        if (tid < R) {
          float s = 1.f, cvar = 0.f;
          if (tid < n_valid) {
            const int row = row0 + tid;
            const float mu = full[tid], raw = full[d_mu * R + tid];
            b.loss[tid] = head_nll(p, ch, row, sq[tid], mu, raw);
            if (binary_head) {
              cvar = sigmoid(mu) - xt[tid];
            } else {
              s = head_var(p, ch, raw);
              const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
              if (!sigma_fixed(p, ch))
                cvar = (-sq[tid] / (2.f * (s * s)) + n_dims / (2.f * s)) * sigmoid(raw);
            }
          }
          s_row[tid] = s;
          c_var[tid] = cvar;
        }
        __syncthreads();
        for (int idx = tid; idx < R * out_last; idx += blockDim.x) {
          const int col = idx / R, r = idx - col * R;
          float cval = 0.f;
          if (r < n_valid) {
            if (binary_head) {
              cval = col == 0 ? c_var[r] : 0.f;
            } else if (col < d_mu) {
              cval = -(tgt(r, col) - full[idx]) / s_row[r];
            } else if (col == d_mu) {
              cval = c_var[r];
            }
          }
          full[idx] = cval;
        }
        __syncthreads();  // sq, s_row and c_var are free for the next chain's loss
      } else if (t <= 2 * L) {
        // Backward layer i: the cotangent of the CTA's own inputs k of the
        // layer, from the whole output cotangent (full, or the buffer
        // backward layer i + 1 wrote), times leaky'(pre) of layer i - 1.
        const int i = 2 * L - t;
        const int in = c.dims[i], out = c.dims[i + 1], out4 = (out + 3) & ~3;
        const int k0 = slice_start(in, rank), nk = slice_start(in, rank + 1) - k0;
        const float* wr = W + boff[ch * kMaxLayers + i];
        const float* cot = i == L - 1 ? b.full : b.act + ((L - 2 - i) & 1) * R * b.as;
        float* dst = b.act + ((L - 1 - i) & 1) * R * b.as;
        const float* pr = i > 0 ? b.pre + poff[ch * kMaxLayers + i - 1] : nullptr;
        for (int idx = tid; idx < R * nk; idx += blockDim.x) {
          const int kl = idx / R, r = idx - kl * R, k = k0 + kl;
          const float gk = dot_rows(cot, r, wr + kl * out4, out);
          if (i > 0) {
            const float gl = gk * (pr[idx] > 0.f ? 1.f : kLeakySlope);
            for (int cc = 0; cc < kCluster; ++cc) cluster.map_shared_rank(dst, cc)[k * R + r] = gl;
          } else if (r < n_valid && !(ch == 2 && k >= p.d0 + p.d1)) {  // f's x column is dropped
            const int col = ch == 1 && k >= p.d0 ? p.d0 + p.d1 + (k - p.d0) : k;
            cluster.map_shared_rank(b.dz, 0)[r * p.z_dim + col] = gk;
          }
        }
      }
    }
    cluster.sync();
  }

  if (rank == 0) {
    const K3Chain g = k3_chain(p, smem, 0), h = k3_chain(p, smem, 1), f = k3_chain(p, smem, 2);
    if (tid < n_valid) {
      // K4's order: ((g + h) + f) + prior
      const float loss = (g.loss[tid] + h.loss[tid]) + f.loss[tid];
      p.out[row0 + tid] = loss + prior_half_sq(p, row0 + tid);
    }
    for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) {
      const int r = idx / p.z_dim;
      if (r < n_valid) {
        const int g_idx = (row0 + r) * p.z_dim + (idx - r * p.z_dim);
        p.grad[g_idx] = ((g.dz[idx] + h.dz[idx]) + f.dz[idx]) + p.z[g_idx];
      }
    }
  }
}

int host_slice(int width, int c) { return width * (c + 1) / kCluster - width * c / kCluster; }

// Fill Params from the C arguments; returns 0 or one of the negative codes above.
int build_params(Params& p, const float* z, const float* x, const float* y, const float* v,
                 float* out, float* grad, int n_rows, int z_dim, int v_dim, int d0, int d1,
                 int d2, int binary, int fixed_mask, float sigma_v, float sigma_x,
                 float sigma_y, const int* n_layers, const int* dims,
                 const void* const* ptrs) {
  p = Params{};
  int di = 0, pi = 0;
  p.width = p.act_stride = p.w_max = p.wt_max = p.b_max = p.pre_stride = 1;
  for (int ch = 0; ch < 3; ++ch) {
    Chain& c = p.chain[ch];
    c.n_layers = n_layers[ch];
    if (c.n_layers < 1 || c.n_layers > kMaxLayers) return kErrTooManyLayers;
    for (int i = 0; i <= c.n_layers; ++i) {
      c.dims[i] = dims[di++];
      if (c.dims[i] < 1) return kErrShape;
      if (c.dims[i] > p.width) p.width = c.dims[i];
    }
    int pre_cols = 0;
    for (int i = 0; i < c.n_layers; ++i) {
      c.w[i] = static_cast<const float*>(ptrs[pi++]);
      c.b[i] = static_cast<const float*>(ptrs[pi++]);
      const int in = c.dims[i], o = c.dims[i + 1];
      if (in > p.act_stride) p.act_stride = in;
      if (in * o > p.w_max) p.w_max = in * o;
      if (in * (o | 1) > p.wt_max) p.wt_max = in * (o | 1);
      if (o > p.b_max) p.b_max = o;
      c.pre_off[i] = pre_cols;
      if (i < c.n_layers - 1) pre_cols += o;
    }
    if (pre_cols > p.pre_stride) p.pre_stride = pre_cols;
  }
  const int d_out[3] = {v_dim + 1, 2, 2};
  for (int ch = 0; ch < 3; ++ch)
    if (p.chain[ch].dims[p.chain[ch].n_layers] < d_out[ch]) return kErrShape;
  if (p.chain[0].dims[0] != z_dim || p.chain[1].dims[0] != d0 + d2 ||
      p.chain[2].dims[0] != d0 + d1 + 1)
    return kErrShape;
  // K3's cluster form: per chain the largest slices over the CTAs, and the
  // layout of its buffers.
  for (int rank = 0; rank < kCluster; ++rank) {
    int w = 0;
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      for (int i = 0; i < c.n_layers; ++i) {
        const int in = c.dims[i], out = c.dims[i + 1];
        w += ((((in + 3) & ~3) + 1) * host_slice(out, rank) + 3) & ~3;
        w += host_slice(in, rank) * ((out + 3) & ~3);
      }
    }
    if (w > p.k3_w) p.k3_w = w;
  }
  int off = p.k3_w;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    int as = 1, pre = 0;
    for (int i = 0; i < c.n_layers; ++i)
      if (c.dims[i] > as) as = c.dims[i];
    for (int rank = 0; rank < kCluster; ++rank) {
      int pr = 0;
      for (int i = 0; i < c.n_layers - 1; ++i) pr += kTileRows * host_slice(c.dims[i + 1], rank);
      if (pr > pre) pre = pr;
    }
    const int sizes[5] = {2 * kTileRows * as, pre, kTileRows * c.dims[c.n_layers],
                          kTileRows * z_dim, kTileRows};
    for (int b = 0; b < 5; ++b) {
      p.k3_off[ch][b] = off;
      off += sizes[b];
    }
    p.k3_as[ch] = as;
  }
  p.k3_vt = off;
  off += kTileRows * (v_dim + 2);
  p.k3_misc = off;
  p.n_groups = (v_dim + 3) / 4;
  p.k3_floats = off + 3 * kTileRows + kTileRows * p.n_groups;
  p.z = z;
  p.x = x;
  p.y = y;
  p.v = v;
  p.out = out;
  p.grad = grad;
  p.n_rows = n_rows;
  p.z_dim = z_dim;
  p.v_dim = v_dim;
  p.d0 = d0;
  p.d1 = d1;
  p.d2 = d2;
  p.binary = binary;
  p.fixed_mask = fixed_mask;
  p.sigma_v = sigma_v;
  p.sigma_x = sigma_x;
  p.sigma_y = sigma_y;
  // K4's weight stream (n_panels -1: more panels than K4 takes)
  for (int ch = 0; ch < 3 && p.n_panels >= 0; ++ch) {
    const Chain& c = p.chain[ch];
    for (int i = 0; i < c.n_layers && p.n_panels >= 0; ++i) {
      const int n_pan = (c.dims[i + 1] + kPanelCols - 1) / kPanelCols;
      if (n_pan > 63 || p.n_panels + n_pan > kMaxPanels) {
        p.n_panels = -1;
      } else {
        for (int j = 0; j < n_pan; ++j) p.panel[p.n_panels++] = (uint16_t)(ch << 12 | i << 6 | j);
      }
    }
  }
  return 0;
}

// K4's shared memory (bytes) for a tile of R rows and S ring slots.
size_t k4_smem_bytes(const Params& p, int R, int S) {
  const size_t as = p.act_stride;
  return sizeof(float) * (2 * R * as + S * (as * kPanelCols + kPanelCols) +
                          (size_t)R * p.n_groups + 3 * (size_t)R);
}

int launch(void (*kernel)(const Params), const Params& p, int blocks, size_t smem,
           void* stream, int threads = kThreads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: out (n_rows,) = negative log-posterior.  n_layers[3]; dims holds the
// three chains' [in, hidden..., out] one after another; ptrs holds per chain
// (w, b) per layer.  Returns 0, a cudaError_t, or one of the negative codes
// above.
int plain_logp(const float* z, const float* x, const float* y, const float* v, float* out,
               int n_rows, int z_dim, int v_dim, int d0, int d1, int d2, int binary,
               int fixed_mask, float sigma_v, float sigma_x, float sigma_y,
               const int* n_layers, const int* dims, const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, out, nullptr, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, n_layers, dims,
                                ptrs);
  if (code != 0) return code;
  if (p.n_panels < 0) return kErrShape;
  p.n_stages = k4_smem_bytes(p, kK4Rows, kK4Stages) <= (size_t)kMaxSmemBytes ? kK4Stages : 2;
  const size_t smem = k4_smem_bytes(p, kK4Rows, p.n_stages);
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (n_rows <= 0) return 0;
  return launch(plain_logp_kernel<kK4Rows, kK4MicroRows>, p, (n_rows + kK4Rows - 1) / kK4Rows,
                smem, stream, 16 * kK4Rows / kK4MicroRows);
}

// K4's row tile.
int plain_logp_tile_rows() { return kK4Rows; }

// K3: out (n_rows,) = negative log-posterior and grad (n_rows, z_dim) = its
// z-gradient.  Arguments as for plain_logp.  Up to kClusterMaxRows rows a
// cluster of 8 CTAs takes each 32-row tile; past it one block does (and the
// one form whose buffers fit takes every row count).
int plain_logp_and_grad(const float* z, const float* x, const float* y, const float* v,
                        float* out, float* grad, int n_rows, int z_dim, int v_dim, int d0,
                        int d1, int d2, int binary, int fixed_mask, float sigma_v,
                        float sigma_x, float sigma_y, const int* n_layers, const int* dims,
                        const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, out, grad, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, n_layers, dims,
                                ptrs);
  if (code != 0) return code;
  const size_t R = kTileRows;
  const size_t smem_tile = sizeof(float) * (R * (p.pre_stride + 2 * (size_t)p.width) +
                                            (size_t)p.wt_max + p.b_max + R * (z_dim + 4 + (size_t)p.n_groups));
  const size_t smem_cluster = sizeof(float) * (size_t)p.k3_floats + sizeof(int) * 9 * kMaxLayers;
  const bool cluster_fits = smem_cluster <= (size_t)kMaxSmemBytes;
  const bool tile_fits = smem_tile <= (size_t)kMaxSmemBytes;
  if (!cluster_fits && !tile_fits) return kErrSmem;
  if (n_rows <= 0) return 0;
  const int tiles = (n_rows + kTileRows - 1) / kTileRows;
  if (cluster_fits && (n_rows <= kClusterMaxRows || !tile_fits))
    return launch(plain_grad_cluster_kernel, p, tiles * kCluster, smem_cluster, stream);
  return launch(plain_grad_kernel, p, tiles, smem_tile, stream);
}

// The row count up to which K3 takes its cluster form.
int plain_grad_cluster_max_rows() { return kClusterMaxRows; }

const char* plain_error_string(int code) {
  switch (code) {
    case kErrTooManyLayers: return "a chain has 0 or more than 20 layers";
    case kErrSmem: return "the tile's buffers for these widths do not fit in 227 KB of shared memory";
    case kErrShape: return "a layer width is < 1 or (K4) over 4032, more than 256 weight panels (K4), or a chain's input or output width is wrong";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
