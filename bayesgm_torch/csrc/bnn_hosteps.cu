// Flipout-BNN CausalBGM negative log-posterior with host-provided weight
// noise (K1), and the same value with its z-gradient (K2).
//
// K1 replaces the TPU kernel bayesgm_tpu/ops/_pk_bnn_hosteps.py::
// make_fused_causal_logp_bnn_hosteps (both its unpaired and paired modes).
// The plain PyTorch version of the same function is
// bayesgm_torch/ops/_pk_bnn_hosteps.py::logp_plain; the two agree to f32
// summation order, and their sign words agree bit for bit.  K2 is described
// above bnn_hosteps_grad_cluster_kernel below.
//
// What it computes, per row: three flipout chains g: z -> (mu_v, s_v),
// h: (z0, z2) -> (mu_x, s_x) and f: (z0, z1, x) -> (mu_y, s_y).  Each chain
// applies the input affine h*gamma_eff + beta, then per layer
//     h <- h @ loc + b + ((h * r_in) @ P[set]) * r_out
// with LeakyReLU(0.2) between layers.  The loss is the Gaussian NLL of v, x
// and y (softplus variance heads or fixed sigmas; Bernoulli logits for a
// binary treatment) plus the N(0, I) prior sum(z^2)/2.  P = sigma * eps comes
// from the host with a leading set axis: set 0 for rows < n_half, set 1 for
// the rest (the paired MH launch stacks [proposed; current]).
//
// Signs: bit k of one 32-bit word per (row, col) per chain is sign matrix k
// (r_in of layer i is bit 2i, r_out bit 2i+1).  The word at (row, col) is
// output col % 4 of Philox4x32-10 at counter (global row, col / 4, chain,
// k / 32) under the key (seed[0], seed[1]); the seed is read from device
// memory, so a step never waits on the host.
//
// Summation order, which K1 and K2 share so that K2's value equals K1's bit
// for bit: each output's two products are fmaf chains over ascending k from
// 0, and the output is (h @ loc + b) + pert.  A row's squared error over a
// chain's mu columns is summed by sq_group and the loop in sq_rows: group q
// (columns 4q .. 4q+3 below d_mu) is an fmaf chain over its columns in
// ascending order, and the row's sum adds the groups in ascending q from 0.
// The chain terms are added to the row's loss in the order g, h, f, and the
// prior last (row_value).
//
// What bounds K1 on an H100: f32 FMA work, no tensor cores.  One paired
// evaluation at the flagship width (g [10, 64x5, 201], h/f [., 64, 32, 8, 2])
// is 139,392 flops per row over ~1.4 KB of row data, about 99 flop/byte, so
// the FMA pipes, not HBM, set its time, as long as the operands reach them:
// an SM moves 128 bytes of shared memory per clock against four warp-wide
// FMAs, so an inner loop that loads an operand per FMA runs at a fraction
// of the FMA rate.  The weights of all layers (~279 KB per eps set) do not
// fit in one block's shared memory.
//
// What the design does about it:
// - Register tiling.  A block of 8 warps takes a tile of 64 rows that all
//   use one eps set (the grid is split at n_half, so a tile never straddles
//   the two sets).  On a 64-column panel each thread computes a micro-tile
//   of 4 rows x 4 columns of both products.  Activations are kept k-major
//   (act[k][row]) with their sign-flipped copy beside them, weights row-major
//   in the panel, so per k a thread makes four 16-byte loads (4 rows of h,
//   4 of h * r_in, 4 columns of loc and of P) for 32 FMAs.  A warp covers 32
//   rows x 16 columns (lane & 7 picks the row quad, lane >> 3 the column
//   quad), so the 8 lanes of a quarter-warp read or write 128 contiguous
//   bytes of activations.
// - Narrow panels (h's and f's 32-, 8- and 2-wide layers, g's 9-column
//   remainder) map a thread to one row and 4 columns: the 64 rows are the
//   parallel axis there.  Columns are padded to a multiple of 4 with zeros
//   in shared memory only.
// - Streamed weights.  Each layer's loc, P[set] and b are cut into panels of
//   at most 64 output columns (33 KB at width 64), which pass through a ring
//   of 3 slots (2 where 3 do not fit) filled by cp.async: while panel p is in
//   the FMAs, panels p+1 and p+2 are in flight, across layer and chain
//   boundaries.  One __syncthreads per panel hands a slot over.
// - The sign words are kept column-major (words[col][row]), so the epilogue
//   reads a micro-tile's four rows in one 16-byte load and writes the next
//   layer's activation and its sign-flipped copy as 16-byte stores; no
//   staging pass sits between layers (except where a chain's sign bits cross
//   into the next 32-bit word, past 16 layers).  A chain's last layer is
//   never written out: its columns fold into the per-row squared-error
//   groups and the variance head, with their targets loaded before the
//   products so that the loads' latency hides behind them.
// - Shared memory at the flagship width: 51 KB of sign words, 4 x 16 KB of
//   activations, 3 x 33 KB of panels and 13 KB of error groups (~225 KB):
//   one block per SM.
// What is left (NVIDIA H100, tools/profile_steps.py and
// tools/ablate_hosteps.py; PERF.md section 6): the paired 40000-row
// evaluation takes ~0.40 ms of device time, ~21 % of its bound.  Without the
// products' inner loop it still takes ~53 % of that; without the 4 x 4
// epilogue or without the weight copies (~279 KB per tile from L2) ~13 %
// less each, without Philox ~3 % less.  626 tiles on 132 SMs take 5 waves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 20;  // per chain (above 16, signs use word group 1)
constexpr int kThreads = 256;
constexpr int kRows = 64;        // K1's row tile
constexpr int kPanelCols = 64;   // K1's weight panel: at most 64 output columns
constexpr int kMaxPanels = 256;
constexpr int kK2Rows = 32;      // K2's row tile
constexpr int kCluster = 8;      // K2's CTAs per row tile
// K2 takes the cluster form up to this many rows; past it, one block per
// 32-row tile (bnn_hosteps_grad_tile_kernel) is faster (tools/ablate_hosteps.py).
constexpr int kClusterMaxRows = 512;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most one block may use
constexpr float kLeakySlope = 0.2f;
constexpr float kEpsF = 1e-6f;

// Error codes of the host functions beside cudaError_t (which is >= 0).
constexpr int kErrTooManyLayers = -1;
constexpr int kErrSmem = -2;
constexpr int kErrShape = -3;

struct Chain {
  int n_layers;
  int dims[kMaxLayers + 1];
  int max_w;  // widest dim of the chain: the sign-word columns
  const float* gamma;
  const float* beta;
  const float* loc[kMaxLayers];
  const float* b[kMaxLayers];
  const float* P[kMaxLayers];  // (n_sets, in, out)
  int pre_off[kMaxLayers];     // K2 (one block per tile): column of hidden layer i's pre-activations
};

struct Params {
  Chain chain[3];
  const float* z;
  const float* x;
  const float* y;
  const float* v;
  const int* seed;
  float* out;
  float* grad;  // K2 only: (n_rows, z_dim)
  int n_rows, n_half, z_dim, v_dim, d0, d1, d2;
  int binary;
  int fixed_mask;  // bit 0: sigma_v fixed, bit 1: sigma_x, bit 2: sigma_y
  float sigma_v, sigma_x, sigma_y;
  int blocks_half0;
  int words_stride;  // max over chains of max_w
  int act_stride;    // max over chains of a layer's input width
  int b_max;         // max over layers of out
  int wt_max;        // K2 (one block per tile): max over layers of in * (out | 1)
  int pre_stride;    // K2 (one block per tile): max over chains of the summed hidden widths
  int n_groups;      // error groups per row: ceil(v_dim / 4)
  // K1's panels, in the order the tile walks them: chain << 12 | layer << 6 | panel
  int n_panels, n_stages;
  uint16_t panel[kMaxPanels];
  // K2's cluster form: the largest per-CTA slices (floats) over the 8 CTAs
  int k2_w, k2_pre, k2_cols, k2_recv, k2_out;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The sign words of rows row0 .. row0 + rows - 1 (0 past n_valid): word
// (r, col) at words[r * rs + col * cs] (K1 keeps them column-major, K2 row-major).
__device__ void fill_words(uint32_t* words, int rs, int cs, int rows, int row0, int n_valid,
                           int cols, int chain, int group, uint2 key) {
  const int q = (cols + 3) / 4;
  for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
    const int c4 = idx / rows, r = idx - c4 * rows;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      w = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)c4,
                                   (uint32_t)chain, (uint32_t)group), key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = 4 * c4 + m;
      if (col < cols) words[r * rs + col * cs] = ws[m];
    }
  }
}

__device__ __forceinline__ float softplus(float r) {
  return fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
}

__device__ __forceinline__ float sigmoid(float r) { return 1.f / (1.f + expf(-r)); }

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

// v with its sign flipped where bit `bit` of the sign word w is set.
__device__ __forceinline__ float flip(float v, uint32_t w, int bit) {
  return ((w >> bit) & 1u) ? -v : v;
}

// Column k of chain ch's input for a row after the frozen-BN affine: g takes
// z, h takes (z0, z2), f takes (z0, z1, x).
__device__ __forceinline__ float chain_in(const Params& p, int ch, int row, int k) {
  const Chain& c = p.chain[ch];
  float u;
  if (ch == 0) {
    u = p.z[row * p.z_dim + k];
  } else if (ch == 1) {
    u = p.z[row * p.z_dim + (k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0))];
  } else {
    u = k < p.d0 + p.d1 ? p.z[row * p.z_dim + k] : p.x[row];
  }
  return fmaf(u, c.gamma[k], c.beta[k]);
}

// The target of chain ch's mu column col: v (from the row's v_row, in device
// or shared memory), x or y.
__device__ __forceinline__ float target(const Params& p, const float* v_row, int ch, int row,
                                        int col) {
  return ch == 0 ? v_row[col] : (ch == 1 ? p.x[row] : p.y[row]);
}

__device__ __forceinline__ int mu_cols(const Params& p, int ch) { return ch == 0 ? p.v_dim : 1; }

// Error group q of a row: the squared differences of columns 4q .. 4q+3
// (the n of them below d_mu) between targets t and mu values m, as an fmaf
// chain in ascending order.
__device__ __forceinline__ float sq_core(int n, const float (&t)[4], const float (&m)[4]) {
  float d = t[0] - m[0];
  float s = fmaf(d, d, 0.f);
  if (n > 1) {
    d = t[1] - m[1];
    s = fmaf(d, d, s);
  }
  if (n > 2) {
    d = t[2] - m[2];
    s = fmaf(d, d, s);
  }
  if (n > 3) {
    d = t[3] - m[3];
    s = fmaf(d, d, s);
  }
  return s;
}

// The targets of error group q of a row (0 past d_mu).
__device__ __forceinline__ void group_targets(const Params& p, const float* v_row, int ch, int row,
                                              int q, float (&t)[4]) {
  const int n = mu_cols(p, ch) - 4 * q;
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = j < n ? target(p, v_row, ch, row, 4 * q + j) : 0.f;
}

__device__ __forceinline__ float sq_group(const Params& p, const float* v_row, int ch, int row,
                                          int q, float m0, float m1, float m2, float m3) {
  float t[4];
  group_targets(p, v_row, ch, row, q, t);
  const float m[4] = {m0, m1, m2, m3};
  return sq_core(mu_cols(p, ch) - 4 * q, t, m);
}

// A row's squared error: its groups added in ascending order from 0.
__device__ __forceinline__ float sq_rows(const float* groups, int n_groups) {
  float s = 0.f;
  for (int q = 0; q < n_groups; ++q) s += groups[q];
  return s;
}

// Chain ch's likelihood term of a row from its squared error sq, its first
// output mu0 and its variance-head output raw; *s and *cv get the variance
// (1 for a binary head) and the cotangent of the last output column that
// carries one (raw's, or the logit's for a binary treatment).
__device__ __forceinline__ float chain_term(const Params& p, int ch, int row, float sq,
                                            float mu0, float raw, float* s_out,
                                            float* cv_out) {
  if (ch == 1 && p.binary) {
    *s_out = 1.f;
    *cv_out = sigmoid(mu0) - p.x[row];
    return fmaxf(mu0, 0.f) - mu0 * p.x[row] + log1pf(expf(-fabsf(mu0)));
  }
  const bool fixed = (p.fixed_mask >> ch) & 1;
  const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
  const float s = fixed ? sigma * sigma : softplus(raw) + kEpsF;
  const float n_dims = (float)mu_cols(p, ch);
  *s_out = s;
  *cv_out = fixed ? 0.f : (-sq / (2.f * (s * s)) + n_dims / (2.f * s)) * sigmoid(raw);
  return sq / (2.f * s) + n_dims * logf(s) / 2.f;
}

// The row's value: its likelihood terms plus the prior sum(z^2) / 2.
__device__ __forceinline__ float row_value(const Params& p, int row, float loss) {
  float zz = 0.f;
  for (int k = 0; k < p.z_dim; ++k) {
    const float zk = p.z[row * p.z_dim + k];
    zz = fmaf(zk, zk, zz);
  }
  return loss + zz / 2.f;
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

// ---------------------------------------------------------------- K1 ----

struct Panel {
  int ch, layer, col0, ncols, width;  // width: ncols padded to a multiple of 4
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

// A slot holds one panel: loc[k][width], then P[set][k][width] at `half`
// floats, then b[width] at 2 * half.
__device__ void issue_panel(const Params& p, int pc, float* slot, int half, int set) {
  const Panel q = panel_at(p, pc);
  const Chain& c = p.chain[q.ch];
  const int in = c.dims[q.layer], out = c.dims[q.layer + 1];
  const float* loc = c.loc[q.layer] + q.col0;
  const float* P = c.P[q.layer] + (size_t)set * in * out + q.col0;
  const float* b = c.b[q.layer] + q.col0;
  float* ls = slot;
  float* ps = slot + half;
  float* bs = slot + 2 * half;
  const int w = q.width;
  // (k, column) of a thread's element, stepped by blockDim.x elements
  // without a division per element
  if (out % 4 == 0 && aligned16(loc) && aligned16(P)) {
    const int w4 = w / 4, dk = blockDim.x / w4, dc = blockDim.x - dk * w4;
    int k = threadIdx.x / w4, c = threadIdx.x - k * w4;
    for (; k < in; k += dk, c += dc) {
      if (c >= w4) {
        c -= w4;
        ++k;
        if (k >= in) break;
      }
      cp_async16(ls + k * w + 4 * c, loc + (size_t)k * out + 4 * c);
      cp_async16(ps + k * w + 4 * c, P + (size_t)k * out + 4 * c);
    }
  } else {
    const int dk = blockDim.x / w, dc = blockDim.x - dk * w;
    int k = threadIdx.x / w, c = threadIdx.x - k * w;
    for (; k < in; k += dk, c += dc) {
      if (c >= w) {
        c -= w;
        ++k;
        if (k >= in) break;
      }
      if (c < q.ncols) {
        cp_async4(ls + k * w + c, loc + (size_t)k * out + c);
        cp_async4(ps + k * w + c, P + (size_t)k * out + c);
      } else {
        ls[k * w + c] = 0.f;
        ps[k * w + c] = 0.f;
      }
    }
  }
  for (int cc = threadIdx.x; cc < w; cc += blockDim.x) {
    if (cc < q.ncols) {
      cp_async4(bs + cc, b + cc);
    } else {
      bs[cc] = 0.f;
    }
  }
}

// What a panel's epilogue needs besides the accumulators.
struct Epi {
  const uint32_t* words;  // [col][row]
  int bit_out;
  int bit_next;  // r_in bit of the next layer, or -1: write no sign-flipped copy
  float* nact;   // next layer's activations [col][row], or null on the last layer
  float* nsgn;
  float* groups;  // last layer: error groups [row][q]
  float* mu0;
  float* raw;
  int ch, row0, n_valid, d_mu, n_groups;
};

// A micro-tile of NR rows r0 .. r0 + NR - 1 and four columns col .. col + 3
// (those < out): am, ap are their two products, bias the panel's b there.
template <int NR>
__device__ __forceinline__ void k1_epilogue(const Params& p, const Epi& e, int r0, int col,
                                            int out, const float* bias, const float (&am)[NR][4],
                                            const float (&ap)[NR][4], const float (&tv)[NR][4]) {
  float pre[NR][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w[NR];
    if (col + j < out) {
      if constexpr (NR == 4) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(e.words + (col + j) * kRows + r0);
        w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
      } else {
        w[0] = e.words[(col + j) * kRows + r0];
      }
    }
    float h[NR], hs[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      pre[i][j] = 0.f;
      if (col + j < out) {
        pre[i][j] = (am[i][j] + bias[j]) + flip(ap[i][j], w[i], e.bit_out);
        h[i] = leaky(pre[i][j]);
        hs[i] = e.bit_next >= 0 ? flip(h[i], w[i], e.bit_next) : 0.f;
      }
    }
    if (e.nact != nullptr && col + j < out) {
      float* na = e.nact + (col + j) * kRows + r0;
      float* ns = e.nsgn + (col + j) * kRows + r0;
      if constexpr (NR == 4) {
        *reinterpret_cast<float4*>(na) = make_float4(h[0], h[1], h[2], h[3]);
        if (e.bit_next >= 0) *reinterpret_cast<float4*>(ns) = make_float4(hs[0], hs[1], hs[2], hs[3]);
      } else {
        na[0] = h[0];
        if (e.bit_next >= 0) ns[0] = hs[0];
      }
    }
  }
  if (e.nact != nullptr) return;
  const int q = col / 4;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r0 + i;
    if (r >= e.n_valid) continue;
    if (4 * q < e.d_mu) e.groups[r * e.n_groups + q] = sq_core(e.d_mu - 4 * q, tv[i], pre[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j == 0) e.mu0[r] = pre[i][j];
      if (col + j == e.d_mu && col + j < out) e.raw[r] = pre[i][j];
    }
  }
}

// A last layer's targets for a micro-tile, loaded before its products so
// that their latency hides behind them.
template <int NR>
__device__ __forceinline__ void k1_targets(const Params& p, const Epi& e, int r0, int col,
                                           float (&tv)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = e.row0 + r0 + i;
    if (e.nact == nullptr && r0 + i < e.n_valid && col < e.d_mu) {
      group_targets(p, p.v + (size_t)row * p.v_dim, e.ch, row, col / 4, tv[i]);
    } else {
      tv[i][0] = tv[i][1] = tv[i][2] = tv[i][3] = 0.f;
    }
  }
}

// One panel of one layer: out columns col0 .. col0 + width - 1 for the
// tile's 64 rows, from act/sgn [k][row] and the panel's slot.
__device__ __forceinline__ void k1_panel(const Params& p, const Epi& e, const Panel& q,
                                         const float* act, const float* sgn,
                                         const float* slot, int half) {
  const Chain& c = p.chain[q.ch];
  const int in = c.dims[q.layer], out = c.dims[q.layer + 1], w = q.width;
  const float* ls = slot;
  const float* ps = slot + half;
  const float* bs = slot + 2 * half;
  const int tid = threadIdx.x;
  if (w == kPanelCols) {
    // 4 x 4 micro-tiles: warp -> (32-row half warp & 1, 16-column quarter
    // warp >> 1), lane -> (row quad lane & 7, column quad lane >> 3).
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = 32 * (warp & 1) + 4 * (lane & 7);
    const int c0 = 16 * (warp >> 1) + 4 * (lane >> 3);
    float am[4][4], ap[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) am[i][j] = ap[i][j] = 0.f;
    float tv[4][4];
    k1_targets<4>(p, e, r0, q.col0 + c0, tv);
#pragma unroll 8
    for (int k = 0; k < in; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(act + k * kRows + r0);
      const float4 s = *reinterpret_cast<const float4*>(sgn + k * kRows + r0);
      const float4 l = *reinterpret_cast<const float4*>(ls + k * kPanelCols + c0);
      const float4 g = *reinterpret_cast<const float4*>(ps + k * kPanelCols + c0);
      const float av[4] = {a.x, a.y, a.z, a.w}, sv[4] = {s.x, s.y, s.z, s.w};
      const float lv[4] = {l.x, l.y, l.z, l.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          am[i][j] = fmaf(av[i], lv[j], am[i][j]);
          ap[i][j] = fmaf(sv[i], gv[j], ap[i][j]);
        }
    }
    k1_epilogue<4>(p, e, r0, q.col0 + c0, out, bs + c0, am, ap, tv);
  } else {
    // One row x 4 columns per thread; a warp takes 32 rows of one column quad.
    const int n_quads = w / 4;
    for (int t = tid; t < kRows * n_quads; t += blockDim.x) {
      const int r = t % kRows, c0 = 4 * (t / kRows);
      float am[1][4] = {{0.f, 0.f, 0.f, 0.f}}, ap[1][4] = {{0.f, 0.f, 0.f, 0.f}}, tv[1][4];
      k1_targets<1>(p, e, r, q.col0 + c0, tv);
#pragma unroll 4
      for (int k = 0; k < in; ++k) {
        const float a = act[k * kRows + r], s = sgn[k * kRows + r];
        const float4 l = *reinterpret_cast<const float4*>(ls + k * w + c0);
        const float4 g = *reinterpret_cast<const float4*>(ps + k * w + c0);
        am[0][0] = fmaf(a, l.x, am[0][0]);
        am[0][1] = fmaf(a, l.y, am[0][1]);
        am[0][2] = fmaf(a, l.z, am[0][2]);
        am[0][3] = fmaf(a, l.w, am[0][3]);
        ap[0][0] = fmaf(s, g.x, ap[0][0]);
        ap[0][1] = fmaf(s, g.y, ap[0][1]);
        ap[0][2] = fmaf(s, g.z, ap[0][2]);
        ap[0][3] = fmaf(s, g.w, ap[0][3]);
      }
      k1_epilogue<1>(p, e, r, q.col0 + c0, out, bs + c0, am, ap, tv);
    }
  }
}

// sgn[k][r] = act[k][r] with r_in (bit `bit` of the words [k][r]) applied.
__device__ void stage_sgn(const float* act, float* sgn, const uint32_t* words, int in, int bit) {
  for (int idx = threadIdx.x; idx < kRows * in; idx += blockDim.x)
    sgn[idx] = flip(act[idx], words[idx], bit);
}

__global__ void __launch_bounds__(kThreads, 1)
bnn_hosteps_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ws = p.words_stride, as = p.act_stride;
  const int half = as * kPanelCols;
  const int slot_floats = 2 * half + kPanelCols;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* act_buf = smem + kRows * ws;  // act[0], sgn[0], act[1], sgn[1]
  float* ring = act_buf + 4 * kRows * as;
  float* groups = ring + p.n_stages * slot_floats;
  float* loss = groups + kRows * p.n_groups;
  float* mu0 = loss + kRows;
  float* raw = mu0 + kRows;

  int set, row0, row_end;
  if ((int)blockIdx.x < p.blocks_half0) {
    set = 0;
    row0 = blockIdx.x * kRows;
    row_end = p.n_half;
  } else {
    set = 1;
    row0 = p.n_half + (blockIdx.x - p.blocks_half0) * kRows;
    row_end = p.n_rows;
  }
  const int n_valid = min(kRows, row_end - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x;
  const int S = p.n_stages;
  if (tid < kRows) loss[tid] = 0.f;

  // Prologue: the first S - 1 panels in flight.
  for (int pc = 0; pc < S - 1; ++pc) {
    if (pc < p.n_panels) issue_panel(p, pc, ring + pc * slot_floats, half, set);
    cp_async_commit();
  }

  int pc = 0, cur = 0;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    int group = 0;
    fill_words(words, 1, kRows, kRows, row0, n_valid, c.max_w, ch, 0, key);
    const int in0 = c.dims[0];
    float* act = act_buf + 2 * cur * kRows * as;
    for (int idx = tid; idx < kRows * in0; idx += blockDim.x) {
      const int k = idx / kRows, r = idx - k * kRows;
      act[idx] = r < n_valid ? chain_in(p, ch, row0 + r, k) : 0.f;
    }
    __syncthreads();
    stage_sgn(act, act + kRows * as, words, in0, 0);

    Epi e;
    e.words = words;
    e.groups = groups;
    e.mu0 = mu0;
    e.raw = raw;
    e.ch = ch;
    e.row0 = row0;
    e.n_valid = n_valid;
    e.d_mu = mu_cols(p, ch);
    e.n_groups = p.n_groups;
    for (int i = 0; i < c.n_layers; ++i) {
      const bool last = i == c.n_layers - 1;
      const float* a = act_buf + 2 * cur * kRows * as;
      float* na = act_buf + 2 * (cur ^ 1) * kRows * as;
      const bool same_group = !last && ((2 * (i + 1)) >> 5) == group;
      e.bit_out = (2 * i + 1) & 31;
      e.bit_next = same_group ? (2 * (i + 1)) & 31 : -1;
      e.nact = last ? nullptr : na;
      e.nsgn = na + kRows * as;
      const int n_pan = (c.dims[i + 1] + kPanelCols - 1) / kPanelCols;
      for (int j = 0; j < n_pan; ++j, ++pc) {
        if (S == 3) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // panel pc and the layer's input are ready; slot (pc - 1) % S is free
        const int next = pc + S - 1;
        if (next < p.n_panels) issue_panel(p, next, ring + (next % S) * slot_floats, half, set);
        cp_async_commit();
        k1_panel(p, e, panel_at(p, pc), a, a + kRows * as, ring + (pc % S) * slot_floats, half);
      }
      if (!last) {
        cur ^= 1;
        if (!same_group) {
          __syncthreads();
          group = (2 * (i + 1)) >> 5;
          fill_words(words, 1, kRows, kRows, row0, n_valid, c.max_w, ch, group, key);
          __syncthreads();
          stage_sgn(na, na + kRows * as, words, c.dims[i + 1], (2 * (i + 1)) & 31);
        }
      }
    }
    __syncthreads();  // the chain's error groups, mu0 and raw are complete
    if (tid < n_valid) {
      float s, cv;
      const float sq = sq_rows(groups + tid * p.n_groups, (e.d_mu + 3) / 4);
      loss[tid] += chain_term(p, ch, row0 + tid, sq, mu0[tid], raw[tid], &s, &cv);
    }
    __syncthreads();  // before the next chain refills the words
  }
  cp_async_wait<0>();
  if (tid < n_valid) p.out[row0 + tid] = row_value(p, row0 + tid, loss[tid]);
}

// ---------------------------------------------------------------- K2 ----

// K2: the K1 value of each row and its gradient with respect to z, through
// the same weight noise (one eps set, never paired).
//
// Replaces the TPU kernel bayesgm_tpu/ops/_pk_bnn_hosteps.py::
// make_fused_causal_logp_and_grad_bnn_hosteps.  Its plain PyTorch version is
// bayesgm_torch/ops/_pk_bnn_hosteps.py::logp_and_grad_plain (autograd of
// logp_plain), independent of the hand-written backward here.
//
// What it computes, per row and chain: K1's forward, keeping each hidden
// layer's pre-activation and the last layer's whole output; the output
// cotangent (-(t - mu) / s on the mu columns, dl/ds * sigmoid(raw) on the
// variance column with dl/ds = -sq / (2 s^2) + d / (2 s), 0 there when sigma
// is fixed; sigmoid(lx) - x on a binary treatment's logit); then per layer,
// last to first,
//     cot_in = cot @ loc^T + ((cot * r_out) @ P^T) * r_in,
// times leaky'(previous pre-activation), and at the input times gamma_eff.
// The chain-input gradients land in z: g's on all of z, h's (z0, z2) on
// [0, d0) and [d0 + d1, d0 + d1 + d2), f's (z0, z1) on [0, d0 + d1) (its x
// column is dropped); the prior adds z.  The value is computed in K1's order
// (see the top of this file), so the two agree bit for bit.
//
// What bounds it on an H100: at the fit batch of 32 rows, latency.  A launch
// walks 28 layer passes in series (g 6 + 6, h 4 + 4, f 4 + 4) for 8.9 MFLOP;
// on one SM that walk, and re-reading every layer's weights from L2 on the
// way, is the whole time.
//
// What the design does about it (bnn_hosteps_grad_cluster_kernel): one
// 32-row tile is spread over a cluster of 8 CTAs that share their shared
// memory (DSMEM).
// - CTA c owns a slice of every layer's output columns (8 of 64, 25 or 26 of
//   g's 201; c * width / 8 up to (c + 1) * width / 8).  At the start it copies
//   its slices of every layer's loc, P and b for all three chains into its
//   shared memory with cp.async (~36 KB at the flagship width), transposed to
//   [column][k] with k padded to a multiple of 4; they stay there for the
//   forward and the backward, and CTA 0 copies the tile's v beside them.
// - Forward: CTA c computes its columns for all 32 rows (K1's order per
//   output, four k per 16-byte weight load), keeps their pre-activations and
//   writes the activations into every CTA's next activation buffer, then one
//   cluster.sync per layer.  The last layer's outputs go to CTA 0, which
//   reduces the loss with K1's device functions and forms the output
//   cotangent; each CTA then reads its slice of it.
// - Backward: for layer i CTA c forms, for every input k, the partial sum
//   over its columns j of cot[j] loc[k, j] + r_in[k] (cot[j] r_out[j]) P[k, j]
//   (a thread takes one row and four k) and writes it to the CTA that owns k
//   (CTA 0 for the chain input), then one cluster.sync.  The owner adds the 8
//   partials in CTA order and applies leaky'(pre[k]), which leaves it the
//   cotangent slice it needs for layer i - 1.  No float atomics: two launches
//   on the same inputs give the same bits.
// What is left (NVIDIA H100, tools/ablate_hosteps.py; PERF.md section 6):
// ~0.08 ms of device time at 32 rows.  Launch and weight copies take ~0.009
// ms, the backward ~0.035 (its partial sums ~0.024), CTA 0's loss and
// cotangent ~0.010; each of the 31 cluster barriers in series costs ~0.43 us
// alone.
// Past kClusterMaxRows rows the cluster form is slower than one block per
// tile (1024 rows: 0.23 against 0.20 ms; 20000 rows: 3.3 against 0.99 ms),
// so the host function sends large batches (BNN MALA's 20000 rows) to
// bnn_hosteps_grad_tile_kernel below.

__device__ __forceinline__ int slice_start(int width, int c) { return width * c / kCluster; }

// The CTA that owns column k of a layer `width` wide.
__device__ __forceinline__ int slice_owner(int width, int k) {
  int o = 0;
  while (o + 1 < kCluster && slice_start(width, o + 1) <= k) ++o;
  return o;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
bnn_hosteps_grad_cluster_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int R = kK2Rows;
  const int rank = (int)cluster.block_rank();
  const int ws = (p.words_stride + 3) & ~3, as = p.act_stride, rw = p.k2_recv;
  const int ow = p.k2_out;  // the widest last layer
  float* W = smem;
  uint32_t* words = reinterpret_cast<uint32_t*>(W + p.k2_w);
  float* act = reinterpret_cast<float*>(words + R * ws);  // 2 x [k][row]
  float* pre = act + 2 * R * as;                         // own hidden pre-activations
  float* cot = pre + p.k2_pre;                           // own cotangent slice [col][row]
  float* recv = cot + R * p.k2_cols;                     // 2 x [src CTA][own col][row]
  float* full = recv + 2 * kCluster * R * rw;            // CTA 0: last layer [col][row]
  float* dz = full + R * ow;                             // CTA 0: [row][z col]
  float* groups = dz + R * p.z_dim;                      // CTA 0: error groups [row][q]
  float* vt = groups + R * p.n_groups;                   // CTA 0: the tile's v [row][col]
  float* loss = vt + R * p.v_dim;
  float* s_row = loss + R;
  float* c_var = s_row + R;
  int* woff = reinterpret_cast<int*>(c_var + R);  // [ch * kMaxLayers + i]
  int* poff = woff + 3 * kMaxLayers;

  const int tile = blockIdx.x / kCluster;
  const int row0 = tile * R;
  const int n_valid = min(R, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x;

  // Resident weights: this CTA's column slice of every layer, all chains.
  if (tid == 0) {
    int w = 0;
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      int pr = 0;
      for (int i = 0; i < c.n_layers; ++i) {
        const int out = c.dims[i + 1];
        const int ns = slice_start(out, rank + 1) - slice_start(out, rank);
        woff[ch * kMaxLayers + i] = w;
        poff[ch * kMaxLayers + i] = pr;
        w += ((2 * ((c.dims[i] + 3) & ~3) + 1) * ns + 3) & ~3;  // 16-byte aligned blocks
        pr += R * ns;
      }
    }
  }
  __syncthreads();
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    for (int i = 0; i < c.n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1], in4 = (in + 3) & ~3;
      const int j0 = slice_start(out, rank), ns = slice_start(out, rank + 1) - j0;
      float* wl = W + woff[ch * kMaxLayers + i];
      float* wp = wl + in4 * ns;
      float* wb = wp + in4 * ns;
      for (int idx = tid; idx < in4 * ns; idx += blockDim.x) {
        const int jl = idx / in4, k = idx - jl * in4;
        if (k < in) {
          cp_async4(wl + idx, c.loc[i] + (size_t)k * out + j0 + jl);
          cp_async4(wp + idx, c.P[i] + (size_t)k * out + j0 + jl);
        } else {
          wl[idx] = 0.f;
          wp[idx] = 0.f;
        }
      }
      for (int jl = tid; jl < ns; jl += blockDim.x) cp_async4(wb + jl, c.b[i] + j0 + jl);
    }
  }
  if (rank == 0) {
    for (int idx = tid; idx < n_valid * p.v_dim; idx += blockDim.x)
      cp_async4(vt + idx, p.v + (size_t)row0 * p.v_dim + idx);
  }
  cp_async_commit();
  if (rank == 0) {
    for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) dz[idx] = 0.f;
    if (tid < R) loss[tid] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  cluster.sync();  // every CTA of the cluster runs before any DSMEM access

  int cur = 0, par = 0;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const int n_layers = c.n_layers, in0 = c.dims[0];
    int group = 0;
    fill_words(words, ws, 1, R, row0, n_valid, c.max_w, ch, 0, key);
    float* a0 = act + cur * R * as;
    for (int idx = tid; idx < R * in0; idx += blockDim.x) {
      const int k = idx / R, r = idx - k * R;
      a0[idx] = r < n_valid ? chain_in(p, ch, row0 + r, k) : 0.f;
    }
    __syncthreads();

    // Forward.
    for (int i = 0; i < n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == n_layers - 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        fill_words(words, ws, 1, R, row0, n_valid, c.max_w, ch, group, key);
        __syncthreads();
      }
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      const int j0 = slice_start(out, rank), ns = slice_start(out, rank + 1) - j0;
      const int in4 = (in + 3) & ~3;
      const float* wl = W + woff[ch * kMaxLayers + i];
      const float* wp = wl + in4 * ns;
      const float* wb = wp + in4 * ns;
      const float* a = act + cur * R * as;
      float* na = act + (cur ^ 1) * R * as;
      float* pr = pre + poff[ch * kMaxLayers + i];
      for (int idx = tid; idx < R * ns; idx += blockDim.x) {
        const int jl = idx / R, r = idx - jl * R, j = j0 + jl;
        const float* lrow = wl + jl * in4;
        const float* prow = wp + jl * in4;
        const uint32_t* wrow = words + r * ws;
        float am = 0.f, ap = 0.f;
        int k = 0;
        for (; k + 4 <= in; k += 4) {
          const float4 l = *reinterpret_cast<const float4*>(lrow + k);
          const float4 g = *reinterpret_cast<const float4*>(prow + k);
          const uint4 w = *reinterpret_cast<const uint4*>(wrow + k);
          const float h0 = a[k * R + r], h1 = a[(k + 1) * R + r];
          const float h2 = a[(k + 2) * R + r], h3 = a[(k + 3) * R + r];
          am = fmaf(h0, l.x, am);
          ap = fmaf(flip(h0, w.x, bit_in), g.x, ap);
          am = fmaf(h1, l.y, am);
          ap = fmaf(flip(h1, w.y, bit_in), g.y, ap);
          am = fmaf(h2, l.z, am);
          ap = fmaf(flip(h2, w.z, bit_in), g.z, ap);
          am = fmaf(h3, l.w, am);
          ap = fmaf(flip(h3, w.w, bit_in), g.w, ap);
        }
        for (; k < in; ++k) {
          const float h = a[k * R + r];
          am = fmaf(h, lrow[k], am);
          ap = fmaf(flip(h, wrow[k], bit_in), prow[k], ap);
        }
        const float v = (am + wb[jl]) + flip(ap, words[r * ws + j], bit_out);
        if (!last) {
          pr[idx] = v;
          const float h = leaky(v);
          for (int cc = 0; cc < kCluster; ++cc) cluster.map_shared_rank(na, cc)[j * R + r] = h;
        } else {
          cluster.map_shared_rank(full, 0)[j * R + r] = v;
        }
      }
      cluster.sync();
      if (!last) cur ^= 1;
    }

    // CTA 0: the chain's likelihood term and its output cotangent.
    const int d_mu = mu_cols(p, ch);
    const int out_last = c.dims[n_layers];
    if (rank == 0) {
      const int nq = (d_mu + 3) / 4;
      for (int idx = tid; idx < n_valid * nq; idx += blockDim.x) {
        const int r = idx / nq, q = idx - r * nq;
        const float* m = full + 4 * q * R + r;
        groups[r * p.n_groups + q] =
            sq_group(p, vt + r * p.v_dim, ch, row0 + r, q, m[0], m[R], m[2 * R], m[3 * R]);
      }
      __syncthreads();
      if (tid < R) {
        float s = 1.f, cv = 0.f;
        if (tid < n_valid) {
          const float sq = sq_rows(groups + tid * p.n_groups, nq);
          loss[tid] += chain_term(p, ch, row0 + tid, sq, full[tid], full[d_mu * R + tid], &s, &cv);
        }
        s_row[tid] = s;
        c_var[tid] = cv;
      }
      __syncthreads();
      const bool binary_head = ch == 1 && p.binary;
      for (int idx = tid; idx < R * out_last; idx += blockDim.x) {
        const int col = idx / R, r = idx - col * R;
        float cval = 0.f;
        if (r < n_valid) {
          if (binary_head) {
            cval = col == 0 ? c_var[r] : 0.f;
          } else if (col < d_mu) {
            cval = -(target(p, vt + r * p.v_dim, ch, row0 + r, col) - full[idx]) / s_row[r];
          } else if (col == d_mu) {
            cval = c_var[r];
          }
        }
        full[idx] = cval;
      }
    }
    cluster.sync();
    {
      const int j0 = slice_start(out_last, rank), ns = slice_start(out_last, rank + 1) - j0;
      const float* src = cluster.map_shared_rank(full, 0);
      for (int idx = tid; idx < R * ns; idx += blockDim.x) cot[idx] = src[j0 * R + idx];
    }
    __syncthreads();

    // Backward, last layer to first.
    for (int i = n_layers - 1; i >= 0; --i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        fill_words(words, ws, 1, R, row0, n_valid, c.max_w, ch, group, key);
        __syncthreads();
      }
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      const int j0 = slice_start(out, rank), ns = slice_start(out, rank + 1) - j0;
      const int in4 = (in + 3) & ~3;
      const float* wl = W + woff[ch * kMaxLayers + i];
      const float* wp = wl + in4 * ns;
      float* rv = recv + par * kCluster * R * rw;
      // Each thread: one row, four inputs k0 .. k0 + 3.
      for (int idx = tid; idx < R * (in4 / 4); idx += blockDim.x) {
        const int k0 = 4 * (idx / R), r = idx - (k0 / 4) * R;
        float g1[4] = {0.f, 0.f, 0.f, 0.f}, g2[4] = {0.f, 0.f, 0.f, 0.f};
        for (int jl = 0; jl < ns; ++jl) {
          const float cv = cot[jl * R + r];
          const float cs = flip(cv, words[r * ws + j0 + jl], bit_out);
          const float4 l = *reinterpret_cast<const float4*>(wl + jl * in4 + k0);
          const float4 g = *reinterpret_cast<const float4*>(wp + jl * in4 + k0);
          g1[0] = fmaf(cv, l.x, g1[0]);
          g1[1] = fmaf(cv, l.y, g1[1]);
          g1[2] = fmaf(cv, l.z, g1[2]);
          g1[3] = fmaf(cv, l.w, g1[3]);
          g2[0] = fmaf(cs, g.x, g2[0]);
          g2[1] = fmaf(cs, g.y, g2[1]);
          g2[2] = fmaf(cs, g.z, g2[2]);
          g2[3] = fmaf(cs, g.w, g2[3]);
        }
        const uint4 w4 = *reinterpret_cast<const uint4*>(words + r * ws + k0);
        const uint32_t wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = k0 + m;
          if (k >= in) break;
          const float part = g1[m] + flip(g2[m], wk[m], bit_in);
          const int o = i == 0 ? 0 : slice_owner(in, k);
          const int kl = i == 0 ? k : k - slice_start(in, o);
          cluster.map_shared_rank(rv, o)[(rank * rw + kl) * R + r] = part;
        }
      }
      cluster.sync();
      if (i > 0) {
        const int k0 = slice_start(in, rank), nk = slice_start(in, rank + 1) - k0;
        const float* pr = pre + poff[ch * kMaxLayers + i - 1];
        for (int idx = tid; idx < R * nk; idx += blockDim.x) {
          const int kl = idx / R, r = idx - kl * R;
          float g = 0.f;
          for (int src = 0; src < kCluster; ++src) g += rv[src * rw * R + idx];
          cot[idx] = g * (pr[idx] > 0.f ? 1.f : kLeakySlope);
        }
        __syncthreads();
      } else if (rank == 0) {
        // The chain-input gradient, scattered into dz.
        for (int idx = tid; idx < R * in0; idx += blockDim.x) {
          const int k = idx / R, r = idx - k * R;
          if (r >= n_valid || (ch == 2 && k >= p.d0 + p.d1)) continue;  // f's x column
          float g = 0.f;
          for (int src = 0; src < kCluster; ++src) g += rv[src * rw * R + idx];
          const int col = ch == 1 && k >= p.d0 ? p.d0 + p.d1 + (k - p.d0) : k;
          dz[r * p.z_dim + col] += g * c.gamma[k];
        }
        __syncthreads();
      }
      par ^= 1;
    }
  }

  if (rank == 0) {
    if (tid < n_valid) p.out[row0 + tid] = row_value(p, row0 + tid, loss[tid]);
    for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) {
      const int r = idx / p.z_dim;
      if (r < n_valid) {
        const int g_idx = (row0 + r) * p.z_dim + (idx - r * p.z_dim);
        p.grad[g_idx] = dz[idx] + p.z[g_idx];
      }
    }
  }
}

// K2 for large batches: one block of 8 warps per 32-row tile, each warp 4
// rows, lanes over the output columns.  Shared memory holds the sign words,
// every hidden pre-activation of the chain (for the leaky' factors), the
// cotangent in two ping-pong buffers (the second aliases the forward's
// activation buffers) and one layer's loc and P, staged per layer.  For the
// backward the weights are staged with an odd row stride (out | 1), so the
// 32 lanes, which walk the input columns k, read 32 different banks.  The
// value is K1's (the same order per output and sq_group per row).
__global__ void __launch_bounds__(kThreads)
bnn_hosteps_grad_tile_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int R = kK2Rows, kRowsPerWarp = R / (kThreads / 32);
  const int ws = p.words_stride, as = p.act_stride;
  const int us = 2 * as > ws ? 2 * as : ws;  // the union buffer's row stride
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* pre = smem + R * ws;
  float* cot = pre + R * p.pre_stride;
  float* uni = cot + R * ws;  // forward: act | sgn; backward: cotangent
  float* wl = uni + R * us;
  float* wp = wl + p.wt_max;
  float* wb = wp + p.wt_max;
  float* dz = wb + p.b_max;
  float* loss = dz + R * p.z_dim;
  float* s_row = loss + R;
  float* c_var = s_row + R;

  const int row0 = blockIdx.x * R;
  const int n_valid = min(R, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ps = p.pre_stride;
  for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) dz[idx] = 0.f;
  if (tid < R) loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const int n_layers = c.n_layers;
    float* act = uni;
    float* sgn = uni + R * as;
    const int in0 = c.dims[0];
    for (int idx = tid; idx < R * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      act[r * as + k] = r < n_valid ? chain_in(p, ch, row0 + r, k) : 0.f;
    }

    // Forward, keeping the pre-activations.
    int group = -1;
    for (int i = 0; i < n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == n_layers - 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        __syncthreads();
        fill_words(words, ws, 1, R, row0, n_valid, c.max_w, ch, group, key);
      }
      __syncthreads();
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      for (int idx = tid; idx < R * in; idx += blockDim.x) {
        const int r = idx / in, k = idx - r * in;
        const float h = i == 0 ? act[r * as + k] : leaky(pre[r * ps + c.pre_off[i - 1] + k]);
        act[r * as + k] = h;
        sgn[r * as + k] = flip(h, words[r * ws + k], bit_in);
      }
      const float* loc = c.loc[i];
      const float* P = c.P[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) {
        wl[idx] = loc[idx];
        wp[idx] = P[idx];
      }
      for (int idx = tid; idx < out; idx += blockDim.x) wb[idx] = c.b[i][idx];
      __syncthreads();

      float* dst = last ? cot : pre + c.pre_off[i];
      const int dst_stride = last ? ws : ps;
      for (int col = lane; col < out; col += 32) {
        float am[kRowsPerWarp], ap[kRowsPerWarp];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) am[j] = ap[j] = 0.f;
        for (int k = 0; k < in; ++k) {
          const float l = wl[k * out + col], q = wp[k * out + col];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int r = warp * kRowsPerWarp + j;
            am[j] = fmaf(act[r * as + k], l, am[j]);
            ap[j] = fmaf(sgn[r * as + k], q, ap[j]);
          }
        }
        const float bc = wb[col];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          dst[r * dst_stride + col] = (am[j] + bc) + flip(ap[j], words[r * ws + col], bit_out);
        }
      }
    }
    __syncthreads();

    // The chain's likelihood term and its output cotangent.
    const int d_mu = mu_cols(p, ch);
    const int out_last = c.dims[n_layers];
    const int nq = (d_mu + 3) / 4;
    float* groups = uni;  // the forward's activations are spent
    for (int idx = tid; idx < n_valid * nq; idx += blockDim.x) {
      const int r = idx / nq, q = idx - r * nq;
      const float* m = cot + r * ws + 4 * q;
      groups[r * nq + q] = sq_group(p, p.v + (size_t)(row0 + r) * p.v_dim, ch, row0 + r, q, m[0],
                                    m[1], m[2], m[3]);
    }
    __syncthreads();
    if (tid < R) {
      float s = 1.f, cv = 0.f;
      if (tid < n_valid) {
        const float* m = cot + tid * ws;
        const float sq = sq_rows(groups + tid * nq, nq);
        loss[tid] += chain_term(p, ch, row0 + tid, sq, m[0], m[d_mu], &s, &cv);
      }
      s_row[tid] = s;
      c_var[tid] = cv;
    }
    __syncthreads();
    const bool binary_head = ch == 1 && p.binary;
    for (int idx = tid; idx < R * out_last; idx += blockDim.x) {
      const int r = idx / out_last, col = idx - r * out_last;
      float cval = 0.f;
      if (r < n_valid) {
        if (binary_head) {
          cval = col == 0 ? c_var[r] : 0.f;
        } else if (col < d_mu) {
          cval = -(target(p, p.v + (size_t)(row0 + r) * p.v_dim, ch, row0 + r, col) -
                   cot[r * ws + col]) / s_row[r];
        } else if (col == d_mu) {
          cval = c_var[r];
        }
      }
      cot[r * ws + col] = cval;
    }

    // Backward, last layer to first.
    float* cur = cot;
    float* nxt = uni;
    for (int i = n_layers - 1; i >= 0; --i) {
      const int in = c.dims[i], out = c.dims[i + 1], ostr = out | 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        __syncthreads();
        fill_words(words, ws, 1, R, row0, n_valid, c.max_w, ch, group, key);
      }
      __syncthreads();
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      const float* loc = c.loc[i];
      const float* P = c.P[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) {
        const int k = idx / out, j = idx - k * out;
        wl[k * ostr + j] = loc[idx];
        wp[k * ostr + j] = P[idx];
      }
      __syncthreads();
      for (int k = lane; k < in; k += 32) {
        float g1[kRowsPerWarp], g2[kRowsPerWarp];
#pragma unroll
        for (int jj = 0; jj < kRowsPerWarp; ++jj) g1[jj] = g2[jj] = 0.f;
        for (int j = 0; j < out; ++j) {
          const float l = wl[k * ostr + j], q = wp[k * ostr + j];
#pragma unroll
          for (int jj = 0; jj < kRowsPerWarp; ++jj) {
            const int r = warp * kRowsPerWarp + jj;
            const float cv = cur[r * ws + j];
            g1[jj] = fmaf(cv, l, g1[jj]);
            g2[jj] = fmaf(flip(cv, words[r * ws + j], bit_out), q, g2[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kRowsPerWarp; ++jj) {
          const int r = warp * kRowsPerWarp + jj;
          float g = g1[jj] + flip(g2[jj], words[r * ws + k], bit_in);
          if (i > 0) {
            g *= pre[r * ps + c.pre_off[i - 1] + k] > 0.f ? 1.f : kLeakySlope;
          } else {
            g *= c.gamma[k];
          }
          nxt[r * ws + k] = g;
        }
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    __syncthreads();

    // Scatter the chain-input gradient into dz.
    for (int idx = tid; idx < R * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      if (r >= n_valid || (ch == 2 && k >= p.d0 + p.d1)) continue;  // f's x column
      const int col = ch == 1 && k >= p.d0 ? p.d0 + p.d1 + (k - p.d0) : k;
      dz[r * p.z_dim + col] += cur[r * ws + k];
    }
    __syncthreads();
  }

  if (tid < n_valid) p.out[row0 + tid] = row_value(p, row0 + tid, loss[tid]);
  for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) {
    const int r = idx / p.z_dim;
    if (r < n_valid) {
      const int g_idx = (row0 + r) * p.z_dim + (idx - r * p.z_dim);
      p.grad[g_idx] = dz[idx] + p.z[g_idx];
    }
  }
}

__global__ void philox_words_kernel(const int* seed, uint32_t* out, int rows,
                                    int cols, int chain, int group) {
  const int q = (cols + 3) / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * q) return;
  const int r = (int)(idx / q), c4 = (int)(idx - (long long)r * q);
  const uint2 key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)r, (uint32_t)c4, (uint32_t)chain, (uint32_t)group), key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int col = 4 * c4 + m;
    if (col < cols) out[(long long)r * cols + col] = ws[m];
  }
}

int host_slice(int width, int c) { return width * (c + 1) / kCluster - width * c / kCluster; }

// Fill the parts of Params that K1 and K2 share from the C arguments;
// returns 0 or one of the negative codes above.
int build_params(Params& p, const float* z, const float* x, const float* y, const float* v,
                 const int* seed, float* out, int n_rows, int z_dim, int v_dim, int d0,
                 int d1, int d2, int binary, int fixed_mask, float sigma_v, float sigma_x,
                 float sigma_y, const int* n_layers, const int* dims,
                 const void* const* ptrs) {
  p = Params{};
  int di = 0, pi = 0;
  p.words_stride = p.act_stride = p.b_max = p.wt_max = p.pre_stride = 1;
  for (int ch = 0; ch < 3; ++ch) {
    Chain& c = p.chain[ch];
    c.n_layers = n_layers[ch];
    if (c.n_layers < 1 || c.n_layers > kMaxLayers) return kErrTooManyLayers;
    c.max_w = 0;
    for (int i = 0; i <= c.n_layers; ++i) {
      c.dims[i] = dims[di++];
      if (c.dims[i] < 1) return kErrShape;
      c.max_w = c.dims[i] > c.max_w ? c.dims[i] : c.max_w;
    }
    c.gamma = static_cast<const float*>(ptrs[pi++]);
    c.beta = static_cast<const float*>(ptrs[pi++]);
    int pre_cols = 0;
    for (int i = 0; i < c.n_layers; ++i) {
      c.loc[i] = static_cast<const float*>(ptrs[pi++]);
      c.b[i] = static_cast<const float*>(ptrs[pi++]);
      c.P[i] = static_cast<const float*>(ptrs[pi++]);
      const int in = c.dims[i], o = c.dims[i + 1];
      if (in > p.act_stride) p.act_stride = in;
      if (in * (o | 1) > p.wt_max) p.wt_max = in * (o | 1);
      if (o > p.b_max) p.b_max = o;
      c.pre_off[i] = pre_cols;
      if (i < c.n_layers - 1) pre_cols += o;
      // K1's panels of this layer
      const int n_pan = (o + kPanelCols - 1) / kPanelCols;
      if (n_pan > 63 || p.n_panels + n_pan > kMaxPanels) return kErrShape;
      for (int j = 0; j < n_pan; ++j) p.panel[p.n_panels++] = (uint16_t)(ch << 12 | i << 6 | j);
    }
    if (pre_cols > p.pre_stride) p.pre_stride = pre_cols;
    if (c.max_w > p.words_stride) p.words_stride = c.max_w;
  }
  const int d_out[3] = {v_dim + 1, 2, 2};
  for (int ch = 0; ch < 3; ++ch)
    if (p.chain[ch].dims[p.chain[ch].n_layers] < d_out[ch]) return kErrShape;
  if (p.chain[0].dims[0] != z_dim || p.chain[1].dims[0] != d0 + d2 ||
      p.chain[2].dims[0] != d0 + d1 + 1)
    return kErrShape;
  p.n_groups = (v_dim + 3) / 4;
  // K2's cluster form: the largest slices over the CTAs.
  p.k2_recv = p.k2_cols = p.k2_out = 1;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    if (c.dims[0] > p.k2_recv) p.k2_recv = c.dims[0];
    if (c.dims[c.n_layers] > p.k2_out) p.k2_out = c.dims[c.n_layers];
  }
  for (int rank = 0; rank < kCluster; ++rank) {
    int w = 0;
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      int pre = 0;
      for (int i = 0; i < c.n_layers; ++i) {
        const int ns = host_slice(c.dims[i + 1], rank);
        w += ((2 * ((c.dims[i] + 3) & ~3) + 1) * ns + 3) & ~3;
        if (i < c.n_layers - 1) pre += kK2Rows * ns;
        if (ns > p.k2_cols) p.k2_cols = ns;
        if (i > 0 && host_slice(c.dims[i], rank) > p.k2_recv) p.k2_recv = host_slice(c.dims[i], rank);
      }
      if (pre > p.k2_pre) p.k2_pre = pre;
    }
    if (w > p.k2_w) p.k2_w = w;
  }
  p.z = z;
  p.x = x;
  p.y = y;
  p.v = v;
  p.seed = seed;
  p.out = out;
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
  return 0;
}

// K1's shared memory with n_stages panel slots, in bytes.
size_t k1_smem(const Params& p, int n_stages) {
  const size_t as = p.act_stride;
  return sizeof(float) * ((size_t)kRows * p.words_stride + 4 * kRows * as +
                          n_stages * (2 * as * kPanelCols + kPanelCols) +
                          (size_t)kRows * p.n_groups + 3 * kRows);
}

size_t k2_cluster_smem(const Params& p) {
  const size_t R = kK2Rows;
  return sizeof(float) * ((size_t)p.k2_w + R * ((p.words_stride + 3) & ~3) + 2 * R * p.act_stride + p.k2_pre +
                          R * p.k2_cols + 2 * kCluster * R * p.k2_recv + R * p.k2_out +
                          R * p.z_dim + R * p.n_groups + R * p.v_dim + 3 * R) +
         sizeof(int) * 6 * kMaxLayers;
}

size_t k2_tile_smem(const Params& p) {
  const size_t R = kK2Rows, ws = p.words_stride, as = p.act_stride;
  const size_t us = 2 * as > ws ? 2 * as : ws;
  return sizeof(float) * (R * (2 * ws + (size_t)p.pre_stride + us) + 2 * (size_t)p.wt_max +
                          p.b_max + R * ((size_t)p.z_dim + 3));
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, void* stream, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n_rows,) = negative log-posterior.  n_layers[3]; dims holds the three
// chains' [in, hidden..., out] one after another; ptrs holds per chain
// gamma_eff, beta, then (loc, b, P) per layer.  Returns 0, a cudaError_t, or
// one of the negative codes above.
int bnn_hosteps_logp(const float* z, const float* x, const float* y, const float* v,
                     const int* seed, float* out, int n_rows, int n_half, int z_dim,
                     int v_dim, int d0, int d1, int d2, int binary, int fixed_mask,
                     float sigma_v, float sigma_x, float sigma_y, const int* n_layers,
                     const int* dims, const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, out, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, n_layers,
                                dims, ptrs);
  if (code != 0) return code;
  p.n_half = n_half;
  p.n_stages = k1_smem(p, 3) <= (size_t)kMaxSmemBytes ? 3 : 2;
  const size_t smem = k1_smem(p, p.n_stages);
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (n_rows <= 0) return 0;
  p.blocks_half0 = (n_half + kRows - 1) / kRows;
  const int blocks = p.blocks_half0 + (n_rows - n_half + kRows - 1) / kRows;
  return launch(bnn_hosteps_kernel, blocks, smem, stream, p);
}

// K2: out (n_rows,) = negative log-posterior and grad (n_rows, z_dim) = its
// z-gradient, one eps set (P is (1, in, out)).  Arguments as for
// bnn_hosteps_logp, without n_half.  Up to kClusterMaxRows rows a cluster
// of 8 CTAs takes each 32-row tile; past it one block does.
int bnn_hosteps_logp_and_grad(const float* z, const float* x, const float* y,
                              const float* v, const int* seed, float* out, float* grad,
                              int n_rows, int z_dim, int v_dim, int d0, int d1, int d2,
                              int binary, int fixed_mask, float sigma_v, float sigma_x,
                              float sigma_y, const int* n_layers, const int* dims,
                              const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, out, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, n_layers,
                                dims, ptrs);
  if (code != 0) return code;
  p.grad = grad;
  p.n_half = n_rows;
  const size_t smem_cluster = k2_cluster_smem(p), smem_tile = k2_tile_smem(p);
  const bool cluster_fits = smem_cluster <= (size_t)kMaxSmemBytes;
  if (!cluster_fits && smem_tile > (size_t)kMaxSmemBytes) return kErrSmem;
  if (n_rows <= 0) return 0;
  const int tiles = (n_rows + kK2Rows - 1) / kK2Rows;
  if (cluster_fits && (n_rows <= kClusterMaxRows || smem_tile > (size_t)kMaxSmemBytes))
    return launch(bnn_hosteps_grad_cluster_kernel, tiles * kCluster, smem_cluster, stream, p);
  return launch(bnn_hosteps_grad_tile_kernel, tiles, smem_tile, stream, p);
}

// out (rows, cols) uint32 = the sign words of `chain`/`group` for rows 0..rows-1.
int bnn_hosteps_sign_words(const int* seed, uint32_t* out, int rows, int cols,
                           int chain, int group, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const long long n = (long long)rows * ((cols + 3) / 4);
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  philox_words_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, rows, cols, chain, group);
  return (int)cudaGetLastError();
}

const char* bnn_hosteps_error_string(int code) {
  switch (code) {
    case kErrTooManyLayers: return "a chain has 0 or more than 20 layers";
    case kErrSmem: return "the tile's buffers for these widths do not fit in 227 KB of shared memory";
    case kErrShape: return "a layer width is < 1 or over 4032, more than 256 weight panels, or a chain's input or output width is wrong";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
