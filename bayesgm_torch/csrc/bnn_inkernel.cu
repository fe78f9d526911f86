// Flipout-BNN CausalBGM negative log-posterior with ALL noise drawn in the
// kernel: K6 (the value), K7 (the value and its z-gradient) and K5 (n_steps
// random-walk MH steps in one launch).
//
// K6 replaces the TPU kernel bayesgm_tpu/ops/_pk_bnn_inkernel.py::
// make_fused_causal_logp_bnn, K7 ::make_fused_causal_logp_and_grad_bnn and
// K5 ::make_fused_mh_steps_bnn.  Their plain PyTorch versions are
// bayesgm_torch/ops/_pk_bnn_inkernel.py::logp_plain, logp_and_grad_plain
// (autograd of logp_plain, independent of the backward here) and
// mh_steps_plain.
//
// What they compute, per row: K1's three flipout chains and loss (see
// csrc/bnn_hosteps.cu), except that the weight noise eps ~ N(0, I) of each
// layer is drawn here, once per logical row block of block_rows rows and per
// evaluation, as the TPU kernel draws it once per grid program: all rows of a
// block share it.  P = sigma * eps, then per layer
//     h <- h @ loc + b + ((h * r_in) @ P) * r_out.
// K5 advances every row's chain n_steps steps with q_sd frozen: proposal
// z + q_sd * N(0, I), both sides evaluated afresh (proposed state first),
// accept when log(max(u, 1e-30)) < logp_prop - logp_cur, and counts[i] the
// rows accepted at step i.
//
// Draws (the layout of bayesgm_torch/ops/_pk_traced_common.py, which the
// plain versions compute the same way): Philox4x32-10 under the key
// (seed[0], seed[1]) with the domain in the top four bits of counter word 3:
//     signs    (row, col / 4, ev, 1<<28 | chain<<8 | group), word col % 4
//     eps      (block, pair / 2, ev, 2<<28 | chain<<8 | layer)
//     proposal (row, pair / 2, step, 3<<28)
//     accept   (row, 0, step, 4<<28), word 0
// with ev = 2 * step + side (side 0 the proposed state, 1 the current one; K6
// and K7 evaluate once, ev = 0).  A pair's u1, u2 are words 0, 1 (even pair)
// or 2, 3 (odd pair), uniforms from the high 24 bits; Box-Muller with u1
// clamped at 1e-7 gives r cos(th) for column j and r sin(th) for column
// ceil(cols / 2) + j.  Built without --use_fast_math (logf, sqrtf, sincosf),
// so the normals match the plain version's to about 1e-6.
//
// What bounds them on an H100: the same f32 FMA work as K1 (139,392 flops
// per row and evaluation at the flagship width), plus generating the weight
// noise.  Eps depends only on the logical block, but a block of 512 rows
// spans several tiles, and each tile regenerates its block's eps for every
// layer and every evaluation: ~34,848 normals per tile-evaluation, about
// one Philox call and one log, sqrt and sincos per two normals.  K5 pays it
// 2 * n_steps times.
//
// What the designs do about it.
// - K7 keeps its first design, a tile of 8 warps x 4 rows (32 rows): per
//   layer loc is staged in shared memory and P = sigma * eps is built there
//   for the tile's block from the eps counter (build_p; no storage, built
//   again on the way back), K2's one-block design (tape of pre-activations,
//   odd-stride transposed staging, gradient scatter, prior + z); ~219 KB of
//   shared memory at the flagship width.  K8's variants run K6's first
//   design (tile_neg_logp, the same 32-row tile without the backward,
//   ~157 KB) until they move onto K5's evaluation.
// - K6 (inkernel_logp_eval_kernel) is one evaluation (ev = 0) of K5's:
//   the tile's z is copied into shared memory and k5_eval runs once over
//   the stream of one evaluation's panels, in K5's tiles and shared memory
//   (~221 KB at the flagship width: one block per SM, 313 tiles at 20000
//   rows in 2.37 rounds).  What is left (NVIDIA H100 80GB HBM3, 700 W;
//   tools/ablate_inkernel.py, PERF.md section 6): ~0.36 ms of device time
//   at 20000 rows, block_rows 512 (12 % of its bound); without the
//   products' inner loop ~24 % less, without P's build ~23 % less (a
//   constant normal in place of the draws ~15 % less), without the weight
//   copies ~10 % less.
// - Summation order.  K6 sums a row's squared error as k5_eval does: an
//   fmaf chain over each group of 4 columns, a 64-wide panel's 16 columns
//   of a slot as (g0 + g1) + (g2 + g3), the slots in ascending order.  K7
//   and K8's variants sum in that order too (k5_order_rows, the slots
//   formed across the block), so K7's value and K8's base equal K6's bit
//   for bit; every output is (h @ loc + b) + signed((h r_in) @ P) with
//   both products fmaf chains over ascending k from 0 in all four.
// - K5's evaluation is K1's register-tiled design (csrc/bnn_hosteps.cu;
//   see "K5" below).  A tile of 64 rows (32 when
//   block_rows is an odd multiple of 32, so that a tile never straddles two
//   logical blocks) keeps its z, the proposal and logp in shared memory for
//   the whole window and reads x, y and v from device memory (20000 x 200
//   f32 stays in the 50 MB L2 across the window); each step draws the
//   proposal, evaluates both sides, draws the accept uniform, updates z and
//   adds the tile's accepts to counts[step] (one atomicAdd per warp).  Each
//   evaluation walks the layers in panels of at most 64 output columns:
//   loc and b through a ring of 3 cp.async slots, P = sigma * eps built into
//   its slot from the eps counter one panel ahead, 4 x 4 micro-tiles of both
//   products over the tile's rows.  Shared memory at the flagship width:
//   51 KB of sign words, 4 x 16 KB of activations, 3 x 33 KB of slots, 4 KB
//   of error slots and 6.5 KB of tile state (~221 KB): one block per SM.
//   Each tile still draws its block's eps itself, for every panel and
//   evaluation (8 tiles per block of 512 rows); 313 tiles at 20000 rows
//   make 2.37 waves on 132 SMs for the whole window.  What is left (NVIDIA
//   H100, tools/ablate_inkernel.py; PERF.md section 6): ~35.5 ms of device
//   time per 50-step launch at 20000 rows, ~12 % of its bound; without the
//   products' inner loop ~23 % less, without P's build ~24 % less (a
//   constant normal in place of the draws ~16 % less), without the weight
//   copies ~10 % less, without the proposal and accept work no less.
// The launchers return kErrSmem when a shape does not fit, and refuse a
// block_rows that is not a multiple of 32 (kErrBlockRows).
//
// K8 (bnn_inkernel_probe) replaces benchmarks/mxu_probe.py::make_probe_kernel,
// the probe that times K6's evaluation with one part switched out; its plain
// version is bayesgm_torch/benchmarks/mxu_probe.py::probe_plain.  The variant
// is a template argument of K6's first design (tile_neg_logp, build_p), one
// __global__ instantiation each; K7 runs kBase.  Per layer:
//     nopert    h @ loc + b: no perturbation product, no signs, no noise
//     noeps     P = sigma * 0.01, signs kept;   epsref  P = sigma * loc
//     nosigns   P = sigma * eps, no signs;      noprng  P = sigma * 0.01, no signs
//     xorsign   base, each sign applied by flipping the float's sign bit
//     blockdiag base's function as one literal product [h, h r_in] @
//               [[loc, 0], [0, P]] over 2 in rows, staged in output-column
//               panels of the block-diagonal weight (zero blocks included),
//               the 2 out columns kept in shared memory (~206 KB in all at
//               the flagship width) and recombined with r_out
//     bf16      base with h, h r_in, loc and P rounded to bf16 (round to
//               nearest even) and staged as bf16 in shared memory, each
//               widened back before its f32 FMA: CUDA cores, not tensor
//               cores, so its time says nothing about a tensor-core product
// Every variant that draws uses K6's counters, so base, xorsign and
// blockdiag see the noise K6 sees.  The probe dissects K6's first design
// (K5's evaluation before K5 took K1's, K6's before it took K5's); the
// variants measure how much of that design's time each part costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLayers = 20;  // per chain (above 16, signs use word group 1)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most one block may use
constexpr float kLeakySlope = 0.2f;
constexpr float kEpsF = 1e-6f;
constexpr float kTwoPi = 2.f * 3.14159265f;  // the TPU kernel's constant
constexpr uint32_t kTagSign = 1u << 28;
constexpr uint32_t kTagEps = 2u << 28;
constexpr uint32_t kTagProposal = 3u << 28;
constexpr uint32_t kTagAccept = 4u << 28;

// Error codes of the host functions beside cudaError_t (which is >= 0).
constexpr int kErrTooManyLayers = -1;
constexpr int kErrSmem = -2;
constexpr int kErrShape = -3;
constexpr int kErrBlockRows = -4;

// K8's variants, in the order of bayesgm_torch/benchmarks/mxu_probe.py's
// KERNEL_VARIANTS; K5, K6 and K7 are kBase.
enum Variant { kBase, kNoPert, kNoEps, kEpsRef, kNoSigns, kXorSign, kNoPrng, kBlockDiag, kBf16 };

template <int V>
struct Probe {
  static constexpr bool kPert = V != kNoPert;  // the (h r_in) @ P product
  static constexpr bool kSigns = kPert && V != kNoSigns && V != kNoPrng;  // r_in, r_out
  static constexpr bool kNormals = V == kBase || V == kNoSigns || V == kXorSign ||
                                   V == kBlockDiag || V == kBf16;  // eps drawn
  using T = typename std::conditional<V == kBf16, __nv_bfloat16, float>::type;  // staged operands
};

template <class T>
__device__ __forceinline__ T to_op(float x);
template <>
__device__ __forceinline__ float to_op<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_op<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float from_op(float x) { return x; }
__device__ __forceinline__ float from_op(__nv_bfloat16 x) { return __bfloat162float(x); }

// h times the Rademacher sign in bit `bit` of `word` (set: -1).
template <int V>
__device__ __forceinline__ float apply_sign(float h, uint32_t word, int bit) {
  if constexpr (V == kXorSign) {
    return __uint_as_float(__float_as_uint(h) ^ (((word >> bit) & 1u) << 31));
  } else {
    return ((word >> bit) & 1u) ? -h : h;
  }
}

struct Chain {
  int n_layers;
  int dims[kMaxLayers + 1];
  int max_w;  // widest dim of the chain: the sign-word columns
  const float* gamma;
  const float* beta;
  const float* loc[kMaxLayers];
  const float* sig[kMaxLayers];
  const float* b[kMaxLayers];
  int pre_off[kMaxLayers];  // K7: column of hidden layer i's pre-activations
};

struct Params {
  Chain chain[3];
  const float* z;
  const float* x;
  const float* y;
  const float* v;
  const int* seed;
  const float* q_sd;  // K5
  float* out;         // K6, K7: (n_rows,); K5: the final logp
  float* grad;        // K7: (n_rows, z_dim)
  float* z_out;       // K5: (n_rows, z_dim)
  float* counts;      // K5: (n_steps,)
  int n_rows, z_dim, v_dim, d0, d1, d2;
  int binary;
  int fixed_mask;  // bit 0: sigma_v fixed, bit 1: sigma_x, bit 2: sigma_y
  float sigma_v, sigma_x, sigma_y;
  int block_rows, n_steps;
  int words_stride;  // max over chains of max_w
  int act_stride;    // max over chains of a layer's input width
  int w_max;         // max over layers of in * out
  int b_max;         // max over layers of out
  int wt_max;        // K7: max over layers of in * (out | 1)
  int pre_stride;    // K7: max over chains of the summed hidden widths
  // K5: its tile's rows, its weight panels in the order a tile walks them
  // (chain << 12 | layer << 6 | panel), the ring's slots and the error slots
  // per row
  int k5_rows, n_panels, n_stages, n_slots;
  uint16_t panel[256];
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

__device__ __forceinline__ float uniform24(uint32_t w) {
  return (float)(w >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// The two normals of one Box-Muller pair, as the TPU kernel's _kernel_normal.
__device__ __forceinline__ void box_muller(uint32_t w1, uint32_t w2, float& c, float& s) {
  const float u1 = fmaxf(uniform24(w1), 1e-7f);
  const float u2 = uniform24(w2);
  const float r = sqrtf(-2.f * logf(u1));
  const float th = kTwoPi * u2;
  float sn, cs;
  sincosf(th, &sn, &cs);
  c = r * cs;
  s = r * sn;
}

// The normals of Philox call ctr.y of a pair-structured draw of `rows` rows
// and `cols` columns (ceil(cols / 2) pairs per row, pair p = row * ch + j):
// put(row, col, value) for each of its (up to) four normals.
template <class Put>
__device__ __forceinline__ void normal_quad(uint4 ctr, uint2 key, int rows, int cols, Put put) {
  const int ch = (cols + 1) >> 1, pairs = rows * ch;
  const uint4 w = philox4x32_10(ctr, key);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int pidx = 2 * (int)ctr.y + m;
    if (pidx < pairs) {
      const int k = pidx / ch, j = pidx - k * ch;
      float c, s;
      box_muller(m ? w.z : w.x, m ? w.w : w.y, c, s);
      put(k, j, c);
      if (ch + j < cols) put(k, ch + j, s);
    }
  }
}

__device__ __forceinline__ uint4 eps_counter(int blk, int q, uint32_t ev, int chain, int layer) {
  return make_uint4((uint32_t)blk, (uint32_t)q, ev,
                    kTagEps | ((uint32_t)chain << 8) | (uint32_t)layer);
}

// put(k, j, eps[k, j]) for each normal of one layer's (in, out) draw.
template <class Put>
__device__ void for_each_eps(int in, int out, int blk, int chain, int layer, uint32_t ev,
                             uint2 key, Put put) {
  const int quads = (in * ((out + 1) >> 1) + 1) >> 1;
  for (int q = threadIdx.x; q < quads; q += blockDim.x)
    normal_quad(eps_counter(blk, q, ev, chain, layer), key, in, out, put);
}

// dst[k * stride + j] = P[k, j] of one layer: sigma[k, j] * eps[k, j] of its
// (in, out) draw, or variant V's stand-in for eps (0.01, or loc).
template <int V, class T>
__device__ void build_p(T* dst, int stride, const float* sig, const float* loc, int in, int out,
                        int blk, int chain, int layer, uint32_t ev, uint2 key) {
  if constexpr (Probe<V>::kNormals) {
    for_each_eps(in, out, blk, chain, layer, ev, key, [&](int k, int j, float e) {
      dst[k * stride + j] = to_op<T>(sig[k * out + j] * e);
    });
  } else {
    for (int idx = threadIdx.x; idx < in * out; idx += blockDim.x) {
      const int k = idx / out, j = idx - k * out;
      dst[k * stride + j] = to_op<T>(sig[idx] * (V == kEpsRef ? loc[idx] : 0.01f));
    }
  }
}

// words[r * stride + col] for the tile's rows (0 past the valid rows).
__device__ void fill_words(uint32_t* words, int stride, int row0, int n_valid, int cols,
                           int chain, int group, uint32_t ev, uint2 key) {
  const int q = (cols + 3) / 4;
  const uint32_t c3 = kTagSign | ((uint32_t)chain << 8) | (uint32_t)group;
  for (int idx = threadIdx.x; idx < kTileRows * q; idx += blockDim.x) {
    const int r = idx / q, c4 = idx - r * q;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      w = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)c4, ev, c3), key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = 4 * c4 + m;
      if (col < cols) words[r * stride + col] = ws[m];
    }
  }
}

__device__ __forceinline__ float softplus(float r) {
  return fmaxf(r, 0.f) + log1pf(expf(-fabsf(r)));
}

__device__ __forceinline__ float sigmoid(float r) { return 1.f / (1.f + expf(-r)); }

// Column k of chain ch's input for tile row r, before the frozen-BN affine: g
// takes z, h takes (z0, z2), f takes (z0, z1, x).
__device__ __forceinline__ float tile_input(const Params& p, int ch, const float* zt,
                                            const float* xt, int r, int k) {
  if (ch == 0) return zt[r * p.z_dim + k];
  if (ch == 1) return zt[r * p.z_dim + (k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0))];
  return k < p.d0 + p.d1 ? zt[r * p.z_dim + k] : xt[r];
}

constexpr int kK5Rows = 64;      // the row layout of K5's and K6's tile
constexpr int kPanelCols = 64;   // a weight panel: at most 64 output columns

// A panel of a layer `out` wide.  A layer of at most 64 columns is one
// natural panel (local column = column).  A wider layer is cut into panels
// of 32 Box-Muller pairs (pairs j0 .. j0 + 31 of a row: columns j0 + c take
// their cosines, columns hc + j0 + c their sines), so that a Philox call's
// normals land in one panel and none is drawn twice: the panel's first
// wcos local columns are its cosine columns, the rest its sine columns.
struct Panel {
  int ch, layer;
  bool paired;
  int hc;          // pairs per row of the layer's draw: ceil(out / 2)
  int j0;          // paired: the first pair; natural: 0
  int ncos, nsin;  // pairs of a row in the panel (natural: hc) and those with a sine column
  int wcos;        // paired: cosine columns padded to a multiple of 4
  int soff;        // local column of pair j0 + c's sine: c + soff
  int width;       // local columns, a multiple of 4
};

__host__ __device__ __forceinline__ Panel panel_geom(int out, int pidx) {
  Panel q;
  q.ch = q.layer = 0;
  q.hc = (out + 1) >> 1;
  q.paired = out > kPanelCols;
  if (!q.paired) {
    q.j0 = 0;
    q.ncos = q.hc;
    q.nsin = out - q.hc;
    q.wcos = (out + 3) & ~3;
    q.soff = q.hc;
    q.width = q.wcos;
  } else {
    q.j0 = (kPanelCols / 2) * pidx;
    q.ncos = min(kPanelCols / 2, q.hc - q.j0);
    q.nsin = max(0, min(kPanelCols / 2, out - q.hc - q.j0));
    q.wcos = (q.ncos + 3) & ~3;
    q.soff = q.wcos;
    q.width = q.wcos + ((q.nsin + 3) & ~3);
  }
  return q;
}

// Panels of a layer `out` wide.
__host__ __device__ __forceinline__ int panels_of(int out) {
  return out <= kPanelCols ? 1 : ((out + 1) / 2 + kPanelCols / 2 - 1) / (kPanelCols / 2);
}

// Error slots a last-layer panel fills per row: one per 16 columns of a
// 64-wide panel, one per 4 columns of a narrower one.
__host__ __device__ __forceinline__ int panel_slots(const Panel& q) {
  return q.width == kPanelCols ? 4 : q.width / 4;
}

// The layer column of local column c, and whether the panel holds it.
__device__ __forceinline__ int panel_col(const Panel& q, int c, bool& valid) {
  if (!q.paired) {
    valid = c < q.ncos + q.nsin;
    return c;
  }
  if (c < q.wcos) {
    valid = c < q.ncos;
    return q.j0 + c;
  }
  valid = c - q.wcos < q.nsin;
  return q.hc + q.j0 + (c - q.wcos);
}

// panel_col's column of local column c0 (a multiple of 4) and how many of
// c0 .. c0 + 3 the panel holds (nv): the group of 4 columns a thread's
// epilogue takes, without panel_col's walk.
__device__ __forceinline__ int panel_quad(const Panel& q, int c0, int& nv) {
  if (!q.paired) {
    nv = max(0, min(4, q.ncos + q.nsin - c0));
    return c0;
  }
  if (c0 < q.wcos) {
    nv = max(0, min(4, q.ncos - c0));
    return q.j0 + c0;
  }
  nv = max(0, min(4, q.nsin - (c0 - q.wcos)));
  return q.hc + q.j0 + (c0 - q.wcos);
}

// Error slot sl of a row over a last layer `out` wide with d_mu mu columns,
// d(col) = target - output, as k5_panel forms it: the slots run panel by
// panel (panel_geom, panel_slots); a group of 4 columns is an fmaf chain in
// ascending order, and a slot of a 64-wide panel adds its 16 columns' four
// groups as (g0 + g1) + (g2 + g3) (k5_panel's shuffles).
template <class D>
__device__ __forceinline__ float k5_slot_sq(int out, int d_mu, int sl, D d) {
  auto group = [&](const Panel& q, int c0) {
    int nv;
    const int tcol = panel_quad(q, c0, nv);
    const int n = min(nv, d_mu - tcol);
    float g = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        const float dj = d(tcol + j);
        g = fmaf(dj, dj, g);
      }
    }
    return g;
  };
  for (int pi = 0;; ++pi) {
    const Panel q = panel_geom(out, pi);
    const int ns = panel_slots(q);
    if (sl < ns) {
      if (q.width != kPanelCols) return group(q, 4 * sl);
      return (group(q, 16 * sl) + group(q, 16 * sl + 4)) +
             (group(q, 16 * sl + 8) + group(q, 16 * sl + 12));
    }
    sl -= ns;
  }
}

// The squared errors sq[r] of the tile's `rows` rows over a last layer `out`
// wide in K6's order (k5_eval: a row's error slots added in ascending order
// from 0; 0 for rows from n_valid on), d(r, col) = target - output.  K7 and
// K8's variants repeat K6's order here: the block's threads form every
// row's slots into slots[r * n_slots + sl] (r fastest), then thread r adds
// its row's.  Call from every thread; the barrier between is inside.
template <class D>
__device__ __forceinline__ void k5_order_rows(int out, int d_mu, int rows, int n_valid, int n_slots, float* slots,
                              float* sq, D d) {
  int n_sl = 0;
  for (int pi = 0; pi < panels_of(out); ++pi) n_sl += panel_slots(panel_geom(out, pi));
  for (int idx = threadIdx.x; idx < rows * n_sl; idx += blockDim.x) {
    const int sl = idx / rows, r = idx - sl * rows;
    slots[r * n_slots + sl] =
        r < n_valid ? k5_slot_sq(out, d_mu, sl, [&](int col) { return d(r, col); }) : 0.f;
  }
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    float acc = 0.f;
    for (int sl = 0; sl < n_sl; ++sl) acc += slots[threadIdx.x * n_slots + sl];
    sq[threadIdx.x] = acc;
  }
}

// One evaluation's shared-memory buffers in K6's first design (K8's variants).
struct EvalSmem {
  uint32_t* words;
  float* act;
  float* sgn;
  float* nxt;
  float* wl;
  float* wp;
  float* wb;
  float* loss;
  float* sq;
  float* mu0;
  float* raw;
  float* slots;  // a last layer's error slots [row][n_slots] (k5_order_rows)
  float* o2;  // K8 blockdiag: the tile's 2 out product columns, row stride 2 b_max
  float* dq;  // a last layer's target - output [row][col], row stride ds: over the words
  int ds;
};

__host__ __device__ size_t eval_smem_floats(const Params& p, bool blockdiag = false) {
  return (size_t)kTileRows * p.words_stride + 3 * (size_t)kTileRows * p.act_stride +
         2 * (size_t)p.w_max + p.b_max + 4 * kTileRows + (size_t)kTileRows * p.n_slots +
         (blockdiag ? 2 * (size_t)kTileRows * p.b_max : 0);
}

__device__ EvalSmem carve_eval(float* smem, const Params& p) {
  EvalSmem s;
  s.words = reinterpret_cast<uint32_t*>(smem);
  s.act = smem + kTileRows * p.words_stride;
  s.sgn = s.act + kTileRows * p.act_stride;
  s.nxt = s.sgn + kTileRows * p.act_stride;
  s.wl = s.nxt + kTileRows * p.act_stride;
  s.wp = s.wl + p.w_max;
  s.wb = s.wp + p.w_max;
  s.loss = s.wb + p.b_max;
  s.sq = s.loss + kTileRows;
  s.mu0 = s.sq + kTileRows;
  s.raw = s.mu0 + kTileRows;
  s.slots = s.raw + kTileRows;
  s.o2 = s.slots + kTileRows * p.n_slots;
  s.dq = reinterpret_cast<float*>(s.words);
  s.ds = p.words_stride;
  return s;
}

// K6's first design, K8's variants' device code: leaves in s.loss[r] the
// negative log-posterior of tile row r < n_valid (prior included; 0 for the
// other rows).  The tile's rows are read from zt (stride z_dim), xt, yt and
// vt (stride v_dim), in device or shared memory; blk is the rows' logical
// block, ev the evaluation.  V is K8's variant; kBase equals K6 bit for bit.
template <int V>
__device__ void tile_neg_logp(const Params& p, const EvalSmem& s, const float* zt,
                              const float* xt, const float* yt, const float* vt, int row0,
                              int n_valid, int blk, uint32_t ev, uint2 key) {
  using T = typename Probe<V>::T;
  constexpr bool kPert = Probe<V>::kPert, kSigns = Probe<V>::kSigns;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int as = p.act_stride, ws = p.words_stride;
  float* act = s.act;
  float* nxt = s.nxt;
  __syncthreads();  // the previous evaluation's readers are done
  if (tid < kTileRows) s.loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    // Chain input after the frozen-BN affine; rows past the tile's end read as 0.
    const int in0 = c.dims[0];
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      act[r * as + k] = r < n_valid ? tile_input(p, ch, zt, xt, r, k) * c.gamma[k] + c.beta[k] : 0.f;
    }

    int group = -1;
    for (int i = 0; i < c.n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == c.n_layers - 1;
      if constexpr (kSigns) {
        if (((2 * i) >> 5) != group) {
          group = (2 * i) >> 5;
          fill_words(s.words, ws, row0, n_valid, c.max_w, ch, group, ev, key);
          __syncthreads();
        }
      }
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;

      // Stage this layer's loc, its P for the block, and the sign-flipped
      // activations (bf16: the rounded activations, then the rounded
      // sign-flipped ones, both in s.sgn).
      const float* loc = c.loc[i];
      for (int idx = tid; idx < kTileRows * in; idx += blockDim.x) {
        const int r = idx / in, k = idx - r * in;
        const float h = act[r * as + k];
        if constexpr (V == kBf16) {
          T* hb = reinterpret_cast<T*>(s.sgn);
          hb[r * as + k] = to_op<T>(h);
          hb[kTileRows * as + r * as + k] = to_op<T>(apply_sign<V>(h, s.words[r * ws + k], bit_in));
        } else if constexpr (kSigns) {
          s.sgn[r * as + k] = apply_sign<V>(h, s.words[r * ws + k], bit_in);
        }
      }
      if constexpr (V != kBlockDiag) {
        T* wl = reinterpret_cast<T*>(s.wl);
        for (int idx = tid; idx < in * out; idx += blockDim.x) wl[idx] = to_op<T>(loc[idx]);
        if constexpr (kPert)
          build_p<V>(reinterpret_cast<T*>(s.wp), out, c.sig[i], loc, in, out, blk, ch, i, ev, key);
      }
      for (int idx = tid; idx < out; idx += blockDim.x) s.wb[idx] = c.b[i][idx];
      __syncthreads();

      const int d_mu = ch == 0 ? p.v_dim : 1;
      // Column col of the warp's rows: am the loc product, ap the
      // perturbation product before r_out.  On the last layer each row's
      // target - output goes to s.dq, over the sign word of the same row and
      // column, which this lane has just read and nothing reads again.
      auto emit = [&](int col, const float* am, const float* ap) {
        const float bc = s.wb[col];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          float pre = am[j] + bc;
          if constexpr (kSigns) {
            pre = pre + apply_sign<V>(ap[j], s.words[r * ws + col], bit_out);
          } else if constexpr (kPert) {
            pre = pre + ap[j];
          }
          if (!last) {
            nxt[r * as + col] = pre > 0.f ? pre : kLeakySlope * pre;
          } else if (r < n_valid) {
            if (col < d_mu) {
              const float t = ch == 0 ? vt[r * p.v_dim + col] : (ch == 1 ? xt[r] : yt[r]);
              s.dq[r * s.ds + col] = t - pre;
            }
            if (col == 0) s.mu0[r] = pre;
            if (col == d_mu) s.raw[r] = pre;
          }
        }
      };

      if constexpr (V == kBlockDiag) {
        // [act, sgn] (2 in columns) @ W2 = [[loc, 0], [0, P]] (2 in x 2 out)
        // into s.o2, W2 staged in panels of pw columns over wl and wp.
        const int os = 2 * p.b_max;
        const int pw = min(2 * out, p.w_max / in);  // >= out: at most two panels
        float* w2 = s.wl;
        const float* sig = c.sig[i];
        for (int c0 = 0; c0 < 2 * out; c0 += pw) {
          const int cw = min(pw, 2 * out - c0);
          if (c0 > 0) __syncthreads();  // the previous panel's readers are done
          for (int idx = tid; idx < 2 * in * cw; idx += blockDim.x) {
            const int k = idx / cw, cc = c0 + (idx - k * cw);
            if (k < in) {
              w2[idx] = cc < out ? loc[k * out + cc] : 0.f;
            } else if (cc < out) {
              w2[idx] = 0.f;
            }
          }
          if (c0 + cw > out)
            for_each_eps(in, out, blk, ch, i, ev, key, [&](int k, int j, float e) {
              const int cc = out + j - c0;
              if (cc >= 0 && cc < cw) w2[(in + k) * cw + cc] = sig[k * out + j] * e;
            });
          __syncthreads();
          for (int col = c0 + lane; col < c0 + cw; col += 32) {
            float acc[kRowsPerWarp];
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.f;
            for (int k = 0; k < in; ++k) {
              const float w = w2[k * cw + col - c0];
#pragma unroll
              for (int j = 0; j < kRowsPerWarp; ++j)
                acc[j] = fmaf(act[(warp * kRowsPerWarp + j) * as + k], w, acc[j]);
            }
            for (int k = 0; k < in; ++k) {
              const float w = w2[(in + k) * cw + col - c0];
#pragma unroll
              for (int j = 0; j < kRowsPerWarp; ++j)
                acc[j] = fmaf(s.sgn[(warp * kRowsPerWarp + j) * as + k], w, acc[j]);
            }
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) s.o2[(warp * kRowsPerWarp + j) * os + col] = acc[j];
          }
        }
        __syncwarp();  // a row's o2 columns are written and read by its own warp
        for (int col = lane; col < out; col += 32) {
          float am[kRowsPerWarp], ap[kRowsPerWarp];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int r = warp * kRowsPerWarp + j;
            am[j] = s.o2[r * os + col];
            ap[j] = s.o2[r * os + out + col];
          }
          emit(col, am, ap);
        }
      } else {
        // bf16: hb holds the rounded activations, then the rounded sign-flipped ones.
        const T* a_op;
        const T* s_op;
        if constexpr (V == kBf16) {
          a_op = reinterpret_cast<const T*>(s.sgn);
          s_op = a_op + kTileRows * as;
        } else {
          a_op = act;
          s_op = kSigns ? s.sgn : act;
        }
        const T* wl = reinterpret_cast<const T*>(s.wl);
        const T* wp = reinterpret_cast<const T*>(s.wp);
        for (int col = lane; col < out; col += 32) {
          float am[kRowsPerWarp], ap[kRowsPerWarp];
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) am[j] = ap[j] = 0.f;
          for (int k = 0; k < in; ++k) {
            const float l = from_op(wl[k * out + col]);
            const float q = kPert ? from_op(wp[k * out + col]) : 0.f;
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) {
              const int r = warp * kRowsPerWarp + j;
              am[j] = fmaf(from_op(a_op[r * as + k]), l, am[j]);
              if constexpr (kPert) ap[j] = fmaf(from_op(s_op[r * as + k]), q, ap[j]);
            }
          }
          emit(col, am, ap);
        }
      }
      __syncthreads();
      float* t = act;
      act = nxt;
      nxt = t;
    }

    // Fold this chain's likelihood term into the row's loss, its squared
    // error summed in K6's order (k5_order_rows).
    k5_order_rows(c.dims[c.n_layers], ch == 0 ? p.v_dim : 1, kTileRows, n_valid, p.n_slots,
                  s.slots, s.sq, [&](int r, int col) { return s.dq[r * s.ds + col]; });
    if (tid < n_valid) {
      const float sq = s.sq[tid];
      float l = s.loss[tid];
      if (ch == 1 && p.binary) {
        const float lx = s.mu0[tid];
        l += fmaxf(lx, 0.f) - lx * xt[tid] + log1pf(expf(-fabsf(lx)));
      } else {
        const bool fixed = (p.fixed_mask >> ch) & 1;
        const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
        const float sv = fixed ? sigma * sigma : softplus(s.raw[tid]) + kEpsF;
        const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
        l += sq / (2.f * sv) + n_dims * logf(sv) / 2.f;
      }
      s.loss[tid] = l;
    }
  }

  if (tid < n_valid) {
    float zz = 0.f;
    for (int k = 0; k < p.z_dim; ++k) {
      const float zk = zt[tid * p.z_dim + k];
      zz = fmaf(zk, zk, zz);
    }
    s.loss[tid] = s.loss[tid] + zz / 2.f;
  }
  __syncthreads();
}

// K8's variant V: out[row] = the negative log-posterior, one evaluation
// (ev = 0).
template <int V>
__global__ void __launch_bounds__(kThreads) inkernel_logp_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const EvalSmem s = carve_eval(reinterpret_cast<float*>(smem4), p);
  const int row0 = blockIdx.x * kTileRows;
  const int n_valid = min(kTileRows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  tile_neg_logp<V>(p, s, p.z + (size_t)row0 * p.z_dim, p.x + row0, p.y + row0,
                p.v + (size_t)row0 * p.v_dim, row0, n_valid, row0 / p.block_rows, 0u, key);
  if ((int)threadIdx.x < n_valid) p.out[row0 + threadIdx.x] = s.loss[threadIdx.x];
}

// ---------------------------------------------------------------- K5 ----
//
// K5's evaluation, which K6 runs once (K1's design, csrc/bnn_hosteps.cu):
// 4 x 4 register micro-tiles over a 64-row layout, activations k-major with
// their sign-flipped copy written by the previous layer's epilogue, sign
// words column-major, and each layer's loc and b streamed in panels of at
// most 64 output columns through a ring of cp.async slots, one
// __syncthreads per panel.  P = sigma * eps of a panel is built from the eps
// counter into its slot one panel ahead, while the previous panel is in the
// FMAs; the stream of panels runs on across the window's 2 * n_steps
// evaluations.  A chain's last layer folds into per-row error slots: one
// per 16 columns of a 64-column panel (the 4 lanes that share a row quad
// reduce by shuffles), one per 4 columns of a narrower panel.

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

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

__device__ __forceinline__ Panel panel_at(const Params& p, int pc) {
  const int code = p.panel[pc];
  const int ch = code >> 12, layer = (code >> 6) & 63;
  Panel q = panel_geom(p.chain[ch].dims[layer + 1], code & 63);
  q.ch = ch;
  q.layer = layer;
  return q;
}

// The sign words of the tile's rows at evaluation ev, column-major:
// words[col * kK5Rows + r] (0 past n_valid).
__device__ void k5_fill_words(uint32_t* words, int row0, int n_valid, int cols, int chain,
                              int group, uint32_t ev, uint2 key) {
  const int q = (cols + 3) / 4;
  const uint32_t c3 = kTagSign | ((uint32_t)chain << 8) | (uint32_t)group;
  for (int idx = threadIdx.x; idx < kK5Rows * q; idx += blockDim.x) {
    const int c4 = idx / kK5Rows, r = idx - c4 * kK5Rows;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      w = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)c4, ev, c3), key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = 4 * c4 + m;
      if (col < cols) words[col * kK5Rows + r] = ws[m];
    }
  }
}

// A slot holds one panel: loc[k][width], then sigma[k][width] at `half`
// floats (made P = sigma * eps in place by k5_build_p), then b[width] at
// 2 * half; columns the panel does not hold are 0.  This copies loc, sigma
// and b.
__device__ void k5_copy_panel(const Params& p, int pc, float* slot, int half) {
  const Panel q = panel_at(p, pc);
  const Chain& c = p.chain[q.ch];
  const int in = c.dims[q.layer], out = c.dims[q.layer + 1];
  const float* loc = c.loc[q.layer];
  const float* sig = c.sig[q.layer];
  const float* b = c.b[q.layer];
  float* ls = slot;
  float* ss = slot + half;
  float* bs = slot + 2 * half;
  const int w = q.width;
  // (k, column) of a thread's element, stepped by blockDim.x elements
  // without a division per element
  if (!q.paired && out % 4 == 0 && aligned16(loc) && aligned16(sig)) {
    const int w4 = w / 4, dk = blockDim.x / w4, dc = blockDim.x - dk * w4;
    int k = threadIdx.x / w4, cc = threadIdx.x - k * w4;
    for (; k < in; k += dk, cc += dc) {
      if (cc >= w4) {
        cc -= w4;
        ++k;
        if (k >= in) break;
      }
      cp_async16(ls + k * w + 4 * cc, loc + (size_t)k * out + 4 * cc);
      cp_async16(ss + k * w + 4 * cc, sig + (size_t)k * out + 4 * cc);
    }
  } else {
    const int dk = blockDim.x / w, dc = blockDim.x - dk * w;
    int k = threadIdx.x / w, cc = threadIdx.x - k * w;
    for (; k < in; k += dk, cc += dc) {
      if (cc >= w) {
        cc -= w;
        ++k;
        if (k >= in) break;
      }
      bool valid;
      const int col = panel_col(q, cc, valid);
      if (valid) {
        cp_async4(ls + k * w + cc, loc + (size_t)k * out + col);
        cp_async4(ss + k * w + cc, sig + (size_t)k * out + col);
      } else {
        ls[k * w + cc] = 0.f;
        ss[k * w + cc] = 0.f;
      }
    }
  }
  for (int cc = threadIdx.x; cc < w; cc += blockDim.x) {
    bool valid;
    const int col = panel_col(q, cc, valid);
    if (valid) {
      cp_async4(bs + cc, b + col);
    } else {
      bs[cc] = 0.f;
    }
  }
}

// ps[k * width + c] *= eps of panel pc's column c for logical block blk at
// evaluation ev, which turns the slot's sigma into P = sigma * eps.  The
// draw is for_each_eps's: pair (k, j) of the layer's (in, out) draw gives
// the cosine of column j and the sine of column hc + j.  A thread takes
// one Philox call of one row's pairs in the panel.
__device__ void k5_build_p(const Params& p, int pc, float* ps, int blk, uint32_t ev, uint2 key) {
  const Panel q = panel_at(p, pc);
  const int w = q.width, hc = q.hc;
  const int in = p.chain[q.ch].dims[q.layer];
  const int per_row = ((q.ncos + 1) >> 1) + 1;  // calls that a row's ncos pairs can span
  for (int idx = threadIdx.x; idx < in * per_row; idx += blockDim.x) {
    const int k = idx / per_row;
    const int p_lo = k * hc + q.j0;  // the row's pairs in the panel: p_lo .. p_lo + ncos - 1
    const int qi = (p_lo >> 1) + (idx - k * per_row);
    if (2 * qi >= p_lo + q.ncos) continue;
    const uint4 w4 = philox4x32_10(eps_counter(blk, qi, ev, q.ch, q.layer), key);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int c = 2 * qi + m - p_lo;
      if (c < 0 || c >= q.ncos) continue;
      float cs, sn;
      box_muller(m ? w4.z : w4.x, m ? w4.w : w4.y, cs, sn);
      ps[k * w + c] *= cs;
      if (c < q.nsin) ps[k * w + q.soff + c] *= sn;
    }
  }
}

// What a panel's epilogue needs besides the accumulators.
struct K5Epi {
  const uint32_t* words;  // [col][row]
  int bit_out;
  int bit_next;  // r_in bit of the next layer, or -1: write no sign-flipped copy
  float* nact;   // next layer's activations [col][row], or null on the last layer
  float* nsgn;
  float* groups;  // last layer: error slots [row][n_slots]
  float* mu0;
  float* raw;
  int ch, row0, n_valid, d_mu, n_slots, slot0;  // slot0: the panel's first error slot
};

// Error group of a row over columns tcol .. tcol + 3: the squared
// differences of the first n of them between targets t and outputs m, an
// fmaf chain in ascending order (0 when n <= 0).
__device__ __forceinline__ float sq_core(int n, const float (&t)[4], const float (&m)[4]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) {
      const float d = t[j] - m[j];
      s = fmaf(d, d, s);
    }
  }
  return s;
}

// A last layer's targets for a micro-tile of NR rows and the nv columns
// from tcol, loaded before its products so that their latency hides behind
// them.
template <int NR>
__device__ __forceinline__ void k5_targets(const Params& p, const K5Epi& e, int r0, int tcol,
                                           int nv, float (&tv)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = e.row0 + r0 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t = 0.f;
      if (e.nact == nullptr && r0 + i < e.n_valid && j < nv && tcol + j < e.d_mu)
        t = e.ch == 0 ? p.v[(size_t)row * p.v_dim + tcol + j] : (e.ch == 1 ? p.x[row] : p.y[row]);
      tv[i][j] = t;
    }
  }
}

// A micro-tile of NR rows r0 .. r0 + NR - 1 and the nv (<= 4) layer columns
// tcol .. tcol + nv - 1: am, ap are their two products, bias the panel's b
// there.  On a last layer each row's error over them goes to sq[i] for the
// caller to reduce.
template <int NR>
__device__ __forceinline__ void k5_epilogue(const K5Epi& e, int r0, int tcol, int nv,
                                            const float* bias, const float (&am)[NR][4],
                                            const float (&ap)[NR][4], const float (&tv)[NR][4],
                                            float (&sq)[NR]) {
  float pre[NR][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w[NR];
    if (j < nv) {
      if constexpr (NR == 4) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(e.words + (tcol + j) * kK5Rows + r0);
        w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
      } else if constexpr (NR == 2) {
        const uint2 w2 = *reinterpret_cast<const uint2*>(e.words + (tcol + j) * kK5Rows + r0);
        w[0] = w2.x, w[1] = w2.y;
      } else {
        w[0] = e.words[(tcol + j) * kK5Rows + r0];
      }
    }
    float h[NR], hs[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      pre[i][j] = 0.f;
      if (j < nv) {
        pre[i][j] = (am[i][j] + bias[j]) + apply_sign<kBase>(ap[i][j], w[i], e.bit_out);
        h[i] = leaky(pre[i][j]);
        hs[i] = e.bit_next >= 0 ? apply_sign<kBase>(h[i], w[i], e.bit_next) : 0.f;
      }
    }
    if (e.nact != nullptr && j < nv) {
      float* na = e.nact + (tcol + j) * kK5Rows + r0;
      float* ns = e.nsgn + (tcol + j) * kK5Rows + r0;
      if constexpr (NR == 4) {
        *reinterpret_cast<float4*>(na) = make_float4(h[0], h[1], h[2], h[3]);
        if (e.bit_next >= 0) *reinterpret_cast<float4*>(ns) = make_float4(hs[0], hs[1], hs[2], hs[3]);
      } else if constexpr (NR == 2) {
        *reinterpret_cast<float2*>(na) = make_float2(h[0], h[1]);
        if (e.bit_next >= 0) *reinterpret_cast<float2*>(ns) = make_float2(hs[0], hs[1]);
      } else {
        na[0] = h[0];
        if (e.bit_next >= 0) ns[0] = hs[0];
      }
    }
  }
  if (e.nact != nullptr) return;
  const int n_sq = min(nv, e.d_mu - tcol);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    sq[i] = sq_core(n_sq, tv[i], pre[i]);
    const int r = r0 + i;
    if (r >= e.n_valid) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nv && tcol + j == 0) e.mu0[r] = pre[i][j];
      if (j < nv && tcol + j == e.d_mu) e.raw[r] = pre[i][j];
    }
  }
}

// One panel of one layer for the tile's 64 rows, from act/sgn [k][row] and
// the panel's slot: 4 x 4 micro-tiles on a 64-wide panel, 2 x 4 on a
// 32-wide one, 1 x 4 on the others.
__device__ __forceinline__ void k5_panel(const Params& p, const K5Epi& e, const Panel& q,
                                         const float* act, const float* sgn,
                                         const float* slot, int half) {
  const int in = p.chain[q.ch].dims[q.layer], w = q.width;
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
    int nv;
    const int tcol = panel_quad(q, c0, nv);
    float am[4][4], ap[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) am[i][j] = ap[i][j] = 0.f;
    float tv[4][4];
    k5_targets<4>(p, e, r0, tcol, nv, tv);
#pragma unroll 8
    for (int k = 0; k < in; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(act + k * kK5Rows + r0);
      const float4 s = *reinterpret_cast<const float4*>(sgn + k * kK5Rows + r0);
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
    float sq[4];
    k5_epilogue<4>(e, r0, tcol, nv, bs + c0, am, ap, tv, sq);
    if (e.nact == nullptr) {
      // The 4 lanes of a row quad hold its 16 columns of this warp.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 8);
        sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 16);
        if ((lane >> 3) == 0 && r0 + i < e.n_valid)
          e.groups[(r0 + i) * e.n_slots + e.slot0 + (warp >> 1)] = sq[i];
      }
    }
  } else if (w == kPanelCols / 2) {
    // 2 x 4 micro-tiles: warp -> column quad, lane -> row pair.
    const int r0 = 2 * (tid & 31), c0 = 4 * (tid >> 5);
    int nv;
    const int tcol = panel_quad(q, c0, nv);
    float am[2][4], ap[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) am[i][j] = ap[i][j] = 0.f;
    float tv[2][4];
    k5_targets<2>(p, e, r0, tcol, nv, tv);
#pragma unroll 8
    for (int k = 0; k < in; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(act + k * kK5Rows + r0);
      const float2 s = *reinterpret_cast<const float2*>(sgn + k * kK5Rows + r0);
      const float4 l = *reinterpret_cast<const float4*>(ls + k * w + c0);
      const float4 g = *reinterpret_cast<const float4*>(ps + k * w + c0);
      const float av[2] = {a.x, a.y}, sv[2] = {s.x, s.y};
      const float lv[4] = {l.x, l.y, l.z, l.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          am[i][j] = fmaf(av[i], lv[j], am[i][j]);
          ap[i][j] = fmaf(sv[i], gv[j], ap[i][j]);
        }
    }
    float sq[2];
    k5_epilogue<2>(e, r0, tcol, nv, bs + c0, am, ap, tv, sq);
    if (e.nact == nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + i < e.n_valid) e.groups[(r0 + i) * e.n_slots + e.slot0 + c0 / 4] = sq[i];
    }
  } else {
    // One row x 4 columns per thread; a warp takes 32 rows of one column quad.
    const int n_quads = w / 4;
    for (int t = tid; t < kK5Rows * n_quads; t += blockDim.x) {
      const int r = t % kK5Rows, c0 = 4 * (t / kK5Rows);
      int nv;
      const int tcol = panel_quad(q, c0, nv);
      float am[1][4] = {{0.f, 0.f, 0.f, 0.f}}, ap[1][4] = {{0.f, 0.f, 0.f, 0.f}}, tv[1][4];
      k5_targets<1>(p, e, r, tcol, nv, tv);
#pragma unroll 4
      for (int k = 0; k < in; ++k) {
        const float a = act[k * kK5Rows + r], s = sgn[k * kK5Rows + r];
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
      float sq[1];
      k5_epilogue<1>(e, r, tcol, nv, bs + c0, am, ap, tv, sq);
      if (e.nact == nullptr && r < e.n_valid) e.groups[r * e.n_slots + e.slot0 + c0 / 4] = sq[0];
    }
  }
}

// sgn[k][r] = act[k][r] with r_in (bit `bit` of the words [k][r]) applied.
__device__ void k5_stage_sgn(const float* act, float* sgn, const uint32_t* words, int in, int bit) {
  for (int idx = threadIdx.x; idx < kK5Rows * in; idx += blockDim.x)
    sgn[idx] = apply_sign<kBase>(act[idx], words[idx], bit);
}

// K5's shared memory, carved from the dynamic buffer.
struct K5Smem {
  uint32_t* words;  // [col][64]
  float* act_buf;   // act[0], sgn[0], act[1], sgn[1], each [k][64]
  float* ring;      // n_stages slots
  float* groups;    // [64][n_slots]
  float* loss;
  float* mu0;
  float* raw;
  float* zt;        // the current state [64][z_dim]
  float* zp;        // the proposal [64][z_dim]
  float* lp_prop;
  float* logp;
  int* accepted;
};

__host__ __device__ size_t k5_smem_floats(const Params& p, int n_stages) {
  const size_t R = kK5Rows, as = p.act_stride;
  return R * p.words_stride + 4 * R * as + n_stages * (2 * as * kPanelCols + kPanelCols) +
         R * p.n_slots + 3 * R + 2 * R * p.z_dim + 3 * R;
}

__device__ K5Smem k5_carve(float* smem, const Params& p) {
  const int R = kK5Rows, as = p.act_stride, zd = p.z_dim;
  K5Smem s;
  s.words = reinterpret_cast<uint32_t*>(smem);
  s.act_buf = smem + R * p.words_stride;
  s.ring = s.act_buf + 4 * R * as;
  s.groups = s.ring + p.n_stages * (2 * as * kPanelCols + kPanelCols);
  s.loss = s.groups + R * p.n_slots;
  s.mu0 = s.loss + R;
  s.raw = s.mu0 + R;
  s.zt = s.raw + R;
  s.zp = s.zt + R * zd;
  s.lp_prop = s.zp + R * zd;
  s.logp = s.lp_prop + R;
  s.accepted = reinterpret_cast<int*>(s.logp + R);
  return s;
}

// The window's stream of panels, one per ring slot: panel G of the stream is
// panel G % n_panels of evaluation G / n_panels.  With 3 slots, while panel
// G is in the FMAs, G + 1 is made P in place and G + 2 is being copied; with
// 2, panel G is made P after its copy lands (one more barrier).
struct K5Stream {
  int G, total, S, NP, half, slot_floats, blk;
  float* ring;
  uint2 key;

  __device__ __forceinline__ float* slot(int g) const { return ring + (g % S) * slot_floats; }

  __device__ __forceinline__ void copy(const Params& p, int g) const {
    if (g < total) k5_copy_panel(p, g % NP, slot(g), half);
    cp_async_commit();
  }

  __device__ __forceinline__ void build(const Params& p, int g) const {
    if (g < total) k5_build_p(p, g % NP, slot(g) + half, blk, (uint32_t)(g / NP), key);
  }

  // Before the loop: the first panels in flight and, with 3 slots, panel 0 made P.
  __device__ __forceinline__ void prologue(const Params& p) const {
    if (total <= 0) return;
    for (int g = 0; g < S - 1; ++g) copy(p, g);
    if (S == 3) {
      cp_async_wait<1>();
      __syncthreads();
      build(p, 0);
    }
  }

  // Makes panel G ready for the FMAs (after a barrier) and keeps the ring
  // going; returns its slot.
  __device__ __forceinline__ const float* next(const Params& p) const {
    cp_async_wait<0>();
    __syncthreads();  // G's copies (and, with 3 slots, G + 1's) landed; slot (G - 1) % S is free
    if (S == 3) {
      copy(p, G + 2);
      build(p, G + 1);
    } else {
      build(p, G);
      __syncthreads();
      copy(p, G + 1);
    }
    return slot(G);
  }
};

// The stream of n_evals evaluations' panels for the tile at row0.
__device__ __forceinline__ K5Stream k5_stream(const Params& p, const K5Smem& s, int n_evals,
                                              int row0, uint2 key) {
  K5Stream st;
  st.G = 0;
  st.total = n_evals * p.n_panels;
  st.S = p.n_stages;
  st.NP = p.n_panels;
  st.half = p.act_stride * kPanelCols;
  st.slot_floats = 2 * st.half + kPanelCols;
  st.blk = row0 / p.block_rows;
  st.ring = s.ring;
  st.key = key;
  return st;
}

// One evaluation of the tile's rows at the state zsrc (shared, [64][z_dim]):
// leaves in s.loss[r] the negative log-posterior of row r < n_valid (prior
// included).  It takes the stream's next n_panels panels; the evaluation is
// ev = st.G / n_panels.
__device__ __forceinline__ void k5_eval(const Params& p, const K5Smem& s, const float* zsrc,
                                        int row0, int n_valid, K5Stream& st) {
  const int tid = threadIdx.x, as = p.act_stride;
  const uint32_t ev = (uint32_t)(st.G / st.NP);
  __syncthreads();  // the previous evaluation's readers are done
  if (tid < kK5Rows) s.loss[tid] = 0.f;
  int cur = 0;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    int group = 0;
    k5_fill_words(s.words, row0, n_valid, c.max_w, ch, 0, ev, st.key);
    const int in0 = c.dims[0];
    float* act = s.act_buf + 2 * cur * kK5Rows * as;
    for (int idx = tid; idx < kK5Rows * in0; idx += blockDim.x) {
      const int k = idx / kK5Rows, r = idx - k * kK5Rows;
      act[idx] = r < n_valid ? tile_input(p, ch, zsrc, p.x + row0, r, k) * c.gamma[k] + c.beta[k]
                             : 0.f;
    }
    __syncthreads();
    k5_stage_sgn(act, act + kK5Rows * as, s.words, in0, 0);

    K5Epi e;
    e.words = s.words;
    e.groups = s.groups;
    e.mu0 = s.mu0;
    e.raw = s.raw;
    e.ch = ch;
    e.row0 = row0;
    e.n_valid = n_valid;
    e.d_mu = ch == 0 ? p.v_dim : 1;
    e.n_slots = p.n_slots;
    int n_sl = 0;  // the last layer's error slots
    for (int i = 0; i < c.n_layers; ++i) {
      const bool last = i == c.n_layers - 1;
      const int out = c.dims[i + 1];
      const float* a = s.act_buf + 2 * cur * kK5Rows * as;
      float* na = s.act_buf + 2 * (cur ^ 1) * kK5Rows * as;
      const bool same_group = !last && ((2 * (i + 1)) >> 5) == group;
      e.bit_out = (2 * i + 1) & 31;
      e.bit_next = same_group ? (2 * (i + 1)) & 31 : -1;
      e.nact = last ? nullptr : na;
      e.nsgn = na + kK5Rows * as;
      const int n_pan = panels_of(out);
      for (int j = 0; j < n_pan; ++j, ++st.G) {
        const float* slot = st.next(p);
        const Panel q = panel_at(p, st.G % st.NP);
        e.slot0 = n_sl;
        k5_panel(p, e, q, a, a + kK5Rows * as, slot, st.half);
        if (last) n_sl += panel_slots(q);
      }
      if (!last) {
        cur ^= 1;
        if (!same_group) {
          __syncthreads();
          group = (2 * (i + 1)) >> 5;
          k5_fill_words(s.words, row0, n_valid, c.max_w, ch, group, ev, st.key);
          __syncthreads();
          k5_stage_sgn(na, na + kK5Rows * as, s.words, out, (2 * (i + 1)) & 31);
        }
      }
    }
    __syncthreads();  // the chain's error slots, mu0 and raw are complete
    if (tid < n_valid) {
      float sq = 0.f;
      for (int q = 0; q < n_sl; ++q) sq += s.groups[tid * p.n_slots + q];
      float l = s.loss[tid];
      if (ch == 1 && p.binary) {
        const float lx = s.mu0[tid];
        const float xr = p.x[row0 + tid];
        l += fmaxf(lx, 0.f) - lx * xr + log1pf(expf(-fabsf(lx)));
      } else {
        const bool fixed = (p.fixed_mask >> ch) & 1;
        const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
        const float sv = fixed ? sigma * sigma : softplus(s.raw[tid]) + kEpsF;
        const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
        l += sq / (2.f * sv) + n_dims * logf(sv) / 2.f;
      }
      s.loss[tid] = l;
    }
    __syncthreads();  // before the next chain refills the words
  }
  if (tid < n_valid) {
    float zz = 0.f;
    for (int k = 0; k < p.z_dim; ++k) {
      const float zk = zsrc[tid * p.z_dim + k];
      zz = fmaf(zk, zk, zz);
    }
    s.loss[tid] = s.loss[tid] + zz / 2.f;
  }
  __syncthreads();
}

// K5: n_steps MH steps for the tile's rows (k5_rows of them: 64, or 32 when
// block_rows is an odd multiple of 32, so that a tile lies in one block), z,
// the proposal and logp held in shared memory for the whole window; x, y
// and v are read from device memory (they stay in L2).
__global__ void __launch_bounds__(kThreads, 1) inkernel_mh_steps_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int R = kK5Rows, zd = p.z_dim;
  const K5Smem s = k5_carve(reinterpret_cast<float*>(smem4), p);

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = blockIdx.x * p.k5_rows;
  const int n_valid = min(p.k5_rows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const float q_sd = *p.q_sd;
  K5Stream st = k5_stream(p, s, 2 * p.n_steps, row0, key);

  for (int idx = tid; idx < R * zd; idx += blockDim.x) {
    s.zt[idx] = idx / zd < n_valid ? p.z[(size_t)row0 * zd + idx] : 0.f;
    s.zp[idx] = 0.f;
  }
  if (tid < R) s.logp[tid] = 0.f;
  st.prologue(p);

  const int quads = (((zd + 1) >> 1) + 1) >> 1;  // Philox calls per row's proposal
  for (int step = 0; step < p.n_steps; ++step) {
    __syncthreads();
    for (int idx = tid; idx < R * quads; idx += blockDim.x) {
      const int r = idx / quads, q = idx - r * quads;
      if (r >= n_valid) continue;
      normal_quad(make_uint4((uint32_t)(row0 + r), (uint32_t)q, (uint32_t)step, kTagProposal),
                  key, 1, zd, [&](int, int j, float e) {
                    s.zp[r * zd + j] = __fadd_rn(s.zt[r * zd + j], __fmul_rn(q_sd, e));
                  });
    }
    // The proposed state (ev = 2 * step), then the current one (2 * step + 1).
    for (int side = 0; side < 2; ++side) {
      k5_eval(p, s, side == 0 ? s.zp : s.zt, row0, n_valid, st);
      if (side == 0 && tid < R) s.lp_prop[tid] = -s.loss[tid];
    }
    if (tid < R) {  // warps 0 and 1, all lanes
      const float lp_cur = -s.loss[tid];
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)(row0 + tid), 0u, (uint32_t)step, kTagAccept), key);
      const float u = fmaxf(uniform24(w.x), 1e-30f);
      const bool acc = tid < n_valid && logf(u) < (s.lp_prop[tid] - lp_cur);
      s.logp[tid] = acc ? s.lp_prop[tid] : lp_cur;
      s.accepted[tid] = acc;
      const int cnt = __popc(__ballot_sync(0xffffffffu, acc));
      if (lane == 0 && cnt) atomicAdd(p.counts + step, (float)cnt);
    }
    __syncthreads();
    for (int idx = tid; idx < R * zd; idx += blockDim.x)
      if (s.accepted[idx / zd]) s.zt[idx] = s.zp[idx];
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < n_valid * zd; idx += blockDim.x)
    p.z_out[(size_t)row0 * zd + idx] = s.zt[idx];
  if (tid < n_valid) p.out[row0 + tid] = s.logp[tid];
}

// K6: out[row] = the negative log-posterior, one evaluation (ev = 0) of
// K5's (k5_eval) for the tile's k5_rows rows (64, or 32 when block_rows is
// an odd multiple of 32), their z copied into shared memory first.
__global__ void __launch_bounds__(kThreads, 1) inkernel_logp_eval_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int R = kK5Rows, zd = p.z_dim;
  const K5Smem s = k5_carve(reinterpret_cast<float*>(smem4), p);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.k5_rows;
  const int n_valid = min(p.k5_rows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  K5Stream st = k5_stream(p, s, 1, row0, key);
  for (int idx = tid; idx < R * zd; idx += blockDim.x)
    s.zt[idx] = idx / zd < n_valid ? p.z[(size_t)row0 * zd + idx] : 0.f;
  st.prologue(p);
  k5_eval(p, s, s.zt, row0, n_valid, st);
  cp_async_wait<0>();
  if (tid < n_valid) p.out[row0 + tid] = s.loss[tid];
}

// K7: the K6 value of each row and its gradient with respect to z, through
// the same draws (ev = 0).  K2's kernel (csrc/bnn_hosteps.cu) with P built
// in shared memory from the eps counter: in the forward with the row stride
// out, and again on the way back with the odd stride out | 1, so nothing of
// P is stored.  The value is computed in K6's loops and order, so the two
// agree bit for bit.
__global__ void __launch_bounds__(kThreads) inkernel_grad_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ws = p.words_stride, as = p.act_stride;
  const int us = 2 * as > ws ? 2 * as : ws;  // the union buffer's row stride
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* pre = smem + kTileRows * ws;
  float* cot = pre + kTileRows * p.pre_stride;
  float* uni = cot + kTileRows * ws;  // forward: act | sgn; backward: cotangent
  float* wl = uni + kTileRows * us;
  float* wp = wl + p.wt_max;
  float* wb = wp + p.wt_max;
  float* dz = wb + p.b_max;
  float* loss = dz + kTileRows * p.z_dim;
  float* sq = loss + kTileRows;
  float* s_row = sq + kTileRows;
  float* c_var = s_row + kTileRows;

  const int row0 = blockIdx.x * kTileRows;
  const int n_valid = min(kTileRows, p.n_rows - row0);
  const int blk = row0 / p.block_rows;
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ps = p.pre_stride;
  const float* zt = p.z + (size_t)row0 * p.z_dim;
  const float* xt = p.x + row0;
  for (int idx = tid; idx < kTileRows * p.z_dim; idx += blockDim.x) dz[idx] = 0.f;
  if (tid < kTileRows) loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    const int n_layers = c.n_layers;
    float* act = uni;
    float* sgn = uni + kTileRows * as;
    const int in0 = c.dims[0];
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      act[r * as + k] = r < n_valid ? tile_input(p, ch, zt, xt, r, k) * c.gamma[k] + c.beta[k] : 0.f;
    }

    // Forward, keeping the pre-activations.
    int group = -1;
    for (int i = 0; i < n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == n_layers - 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        __syncthreads();
        fill_words(words, ws, row0, n_valid, c.max_w, ch, group, 0u, key);
      }
      __syncthreads();
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      for (int idx = tid; idx < kTileRows * in; idx += blockDim.x) {
        const int r = idx / in, k = idx - r * in;
        float h;
        if (i == 0) {
          h = act[r * as + k];
        } else {
          const float q = pre[r * ps + c.pre_off[i - 1] + k];
          h = q > 0.f ? q : kLeakySlope * q;
          act[r * as + k] = h;
        }
        sgn[r * as + k] = ((words[r * ws + k] >> bit_in) & 1u) ? -h : h;
      }
      const float* loc = c.loc[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) wl[idx] = loc[idx];
      build_p<kBase>(wp, out, c.sig[i], loc, in, out, blk, ch, i, 0u, key);
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
          const float pert = ((words[r * ws + col] >> bit_out) & 1u) ? -ap[j] : ap[j];
          dst[r * dst_stride + col] = (am[j] + bc) + pert;
        }
      }
    }
    __syncthreads();

    // The chain's likelihood term and its output cotangent.  The mu
    // columns of cot become target - output in place (not a binary
    // treatment's logit, whose loss does not use them); the squared error
    // is summed from them as K6 sums it (k5_order_rows; its slots in uni,
    // which the forward is done with).
    const int d_mu = ch == 0 ? p.v_dim : 1;
    const int out_last = c.dims[n_layers];
    const bool binary_head = ch == 1 && p.binary;
    if (!binary_head) {
      for (int idx = tid; idx < n_valid * d_mu; idx += blockDim.x) {
        const int r = idx / d_mu, col = idx - r * d_mu, row = row0 + r;
        const float t = ch == 0 ? p.v[(size_t)row * p.v_dim + col] : (ch == 1 ? p.x[row] : p.y[row]);
        cot[r * ws + col] = t - cot[r * ws + col];
      }
      __syncthreads();
    }
    k5_order_rows(out_last, d_mu, kTileRows, n_valid, p.n_slots, uni, sq,
                  [&](int r, int col) { return cot[r * ws + col]; });
    if (tid < kTileRows) {
      float sv = 1.f, cv = 0.f;
      if (tid < n_valid) {
        const int row = row0 + tid;
        float l = loss[tid];
        if (ch == 1 && p.binary) {
          const float lx = cot[tid * ws];
          l += fmaxf(lx, 0.f) - lx * p.x[row] + log1pf(expf(-fabsf(lx)));
          cv = sigmoid(lx) - p.x[row];
        } else {
          const bool fixed = (p.fixed_mask >> ch) & 1;
          const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
          const float raw = cot[tid * ws + d_mu];
          sv = fixed ? sigma * sigma : softplus(raw) + kEpsF;
          const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
          l += sq[tid] / (2.f * sv) + n_dims * logf(sv) / 2.f;
          if (!fixed) cv = (-sq[tid] / (2.f * (sv * sv)) + n_dims / (2.f * sv)) * sigmoid(raw);
        }
        loss[tid] = l;
      }
      s_row[tid] = sv;
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
          cval = -cot[r * ws + col] / s_row[r];  // cot holds target - output
        } else if (col == d_mu) {
          cval = c_var[r];
        }
      }
      cot[r * ws + col] = cval;
    }

    // Backward, last layer to first, P regenerated with the odd stride.
    float* cur = cot;
    float* nxt = uni;
    for (int i = n_layers - 1; i >= 0; --i) {
      const int in = c.dims[i], out = c.dims[i + 1], ostr = out | 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        __syncthreads();
        fill_words(words, ws, row0, n_valid, c.max_w, ch, group, 0u, key);
      }
      __syncthreads();
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;
      const float* loc = c.loc[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) {
        const int k = idx / out, j = idx - k * out;
        wl[k * ostr + j] = loc[idx];
      }
      build_p<kBase>(wp, ostr, c.sig[i], loc, in, out, blk, ch, i, 0u, key);
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
            const float cs = ((words[r * ws + j] >> bit_out) & 1u) ? -cv : cv;
            g1[jj] = fmaf(cv, l, g1[jj]);
            g2[jj] = fmaf(cs, q, g2[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kRowsPerWarp; ++jj) {
          const int r = warp * kRowsPerWarp + jj;
          float g = g1[jj] + (((words[r * ws + k] >> bit_in) & 1u) ? -g2[jj] : g2[jj]);
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

  if (tid < n_valid) {
    float zz = 0.f;
    for (int k = 0; k < p.z_dim; ++k) {
      const float zk = zt[tid * p.z_dim + k];
      zz = fmaf(zk, zk, zz);
    }
    p.out[row0 + tid] = loss[tid] + zz / 2.f;
  }
  for (int idx = tid; idx < kTileRows * p.z_dim; idx += blockDim.x) {
    const int r = idx / p.z_dim;
    if (r < n_valid) {
      const size_t g_idx = (size_t)row0 * p.z_dim + idx;
      p.grad[g_idx] = dz[idx] + p.z[g_idx];
    }
  }
}

// The draws on their own, for checking them against the plain version's.
__global__ void sign_words_kernel(const int* seed, uint32_t* out, int rows, int cols,
                                  int chain, int group, uint32_t ev) {
  const int q = (cols + 3) / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * q) return;
  const int r = (int)(idx / q), c4 = (int)(idx - (long long)r * q);
  const uint2 key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  const uint4 w = philox4x32_10(
      make_uint4((uint32_t)r, (uint32_t)c4, ev,
                 kTagSign | ((uint32_t)chain << 8) | (uint32_t)group), key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int col = 4 * c4 + m;
    if (col < cols) out[(long long)r * cols + col] = ws[m];
  }
}

// out (n_blocks, rows, cols) = eps of one layer in every block.
__global__ void eps_kernel(const int* seed, float* out, int n_blocks, int rows, int cols,
                           int chain, int layer, uint32_t ev) {
  const int quads = (rows * ((cols + 1) >> 1) + 1) >> 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_blocks * quads) return;
  const int blk = (int)(idx / quads), q = (int)(idx - (long long)blk * quads);
  const uint2 key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  float* dst = out + (size_t)blk * rows * cols;
  normal_quad(eps_counter(blk, q, ev, chain, layer), key, rows, cols,
              [&](int k, int j, float e) { dst[k * cols + j] = e; });
}

// out (rows, z_dim) = step `step`'s proposal normals.
__global__ void proposal_kernel(const int* seed, float* out, int rows, int z_dim, int step) {
  const int quads = (((z_dim + 1) >> 1) + 1) >> 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * quads) return;
  const int r = (int)(idx / quads), q = (int)(idx - (long long)r * quads);
  const uint2 key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  normal_quad(make_uint4((uint32_t)r, (uint32_t)q, (uint32_t)step, kTagProposal), key, 1,
              z_dim, [&](int, int j, float e) { out[(size_t)r * z_dim + j] = e; });
}

// out (rows,) = step `step`'s accept uniforms (before the 1e-30 clamp).
__global__ void accept_kernel(const int* seed, float* out, int rows, int step) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint2 key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
  out[r] = uniform24(
      philox4x32_10(make_uint4((uint32_t)r, 0u, (uint32_t)step, kTagAccept), key).x);
}

// Fill the parts of Params that K5, K6 and K7 share from the C arguments;
// returns 0 or one of the negative codes above.
int build_params(Params& p, const float* z, const float* x, const float* y, const float* v,
                 const int* seed, float* out, int n_rows, int z_dim, int v_dim, int d0,
                 int d1, int d2, int binary, int fixed_mask, float sigma_v, float sigma_x,
                 float sigma_y, int block_rows, const int* n_layers, const int* dims,
                 const void* const* ptrs) {
  p = Params{};
  int di = 0, pi = 0;
  p.words_stride = p.act_stride = p.w_max = p.b_max = p.wt_max = p.pre_stride = 1;
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
      c.sig[i] = static_cast<const float*>(ptrs[pi++]);
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
    if (c.max_w > p.words_stride) p.words_stride = c.max_w;
  }
  const int d_out[3] = {v_dim + 1, 2, 2};
  for (int ch = 0; ch < 3; ++ch)
    if (p.chain[ch].dims[p.chain[ch].n_layers] < d_out[ch]) return kErrShape;
  if (p.chain[0].dims[0] != z_dim || p.chain[1].dims[0] != d0 + d2 ||
      p.chain[2].dims[0] != d0 + d1 + 1)
    return kErrShape;
  if (block_rows < kTileRows || block_rows % kTileRows != 0) return kErrBlockRows;
  for (int ch = 0; ch < 3; ++ch) {  // a last layer's error slots per row, the most over chains
    const int out = p.chain[ch].dims[p.chain[ch].n_layers];
    int n_sl = 0;
    for (int j = 0; j < panels_of(out); ++j) n_sl += panel_slots(panel_geom(out, j));
    if (n_sl > p.n_slots) p.n_slots = n_sl;
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
  p.block_rows = block_rows;
  return 0;
}

template <class Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, void* stream) {
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (p.n_rows <= 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.n_rows + kTileRows - 1) / kTileRows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int grid_1d(long long n) { return (int)((n + 255) / 256); }

// K5's and K6's evaluation: the tile's rows, the weight panels in the order
// a tile walks them, the error slots per row and the ring's slots (3, or 2
// where 3 do not fit).  Returns 0, kErrShape or kErrSmem; *smem gets the
// bytes of shared memory.
int k5_setup(Params& p, size_t* smem) {
  p.k5_rows = p.block_rows % kK5Rows == 0 ? kK5Rows : kTileRows;  // a tile lies in one block
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    for (int i = 0; i < c.n_layers; ++i) {
      const int n_pan = panels_of(c.dims[i + 1]);
      if (n_pan > 63 || p.n_panels + n_pan > 256) return kErrShape;
      for (int j = 0; j < n_pan; ++j) p.panel[p.n_panels++] = (uint16_t)(ch << 12 | i << 6 | j);
    }
  }
  p.n_stages = sizeof(float) * k5_smem_floats(p, 3) <= (size_t)kMaxSmemBytes ? 3 : 2;
  *smem = sizeof(float) * k5_smem_floats(p, p.n_stages);
  return *smem > (size_t)kMaxSmemBytes ? kErrSmem : 0;
}

// Launch a kernel over K5's tiles.
int launch_k5(void (*kernel)(const Params), const Params& p, size_t smem, void* stream) {
  if (p.n_rows <= 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.n_rows + p.k5_rows - 1) / p.k5_rows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6: out (n_rows,) = negative log-posterior.  n_layers[3]; dims holds the
// three chains' [in, hidden..., out] one after another; ptrs holds per chain
// gamma_eff, beta, then (loc, sigma, b) per layer.  Returns 0, a
// cudaError_t, or one of the negative codes above.
int bnn_inkernel_logp(const float* z, const float* x, const float* y, const float* v,
                      const int* seed, float* out, int n_rows, int z_dim, int v_dim, int d0,
                      int d1, int d2, int binary, int fixed_mask, float sigma_v,
                      float sigma_x, float sigma_y, int block_rows, const int* n_layers,
                      const int* dims, const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, out, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, block_rows,
                                n_layers, dims, ptrs);
  if (code != 0) return code;
  size_t smem;
  const int setup = k5_setup(p, &smem);
  if (setup != 0) return setup;
  return launch_k5(inkernel_logp_eval_kernel, p, smem, stream);
}

// K8: variant `variant` (the order of enum Variant) of K6's evaluation;
// other arguments as for bnn_inkernel_logp.  kErrShape for an unknown variant.
int bnn_inkernel_probe(int variant, const float* z, const float* x, const float* y,
                       const float* v, const int* seed, float* out, int n_rows, int z_dim,
                       int v_dim, int d0, int d1, int d2, int binary, int fixed_mask,
                       float sigma_v, float sigma_x, float sigma_y, int block_rows,
                       const int* n_layers, const int* dims, const void* const* ptrs,
                       void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, out, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, block_rows,
                                n_layers, dims, ptrs);
  if (code != 0) return code;
  const size_t smem = sizeof(float) * eval_smem_floats(p, variant == kBlockDiag);
  switch (variant) {
    case kBase: return launch(inkernel_logp_kernel<kBase>, p, smem, stream);
    case kNoPert: return launch(inkernel_logp_kernel<kNoPert>, p, smem, stream);
    case kNoEps: return launch(inkernel_logp_kernel<kNoEps>, p, smem, stream);
    case kEpsRef: return launch(inkernel_logp_kernel<kEpsRef>, p, smem, stream);
    case kNoSigns: return launch(inkernel_logp_kernel<kNoSigns>, p, smem, stream);
    case kXorSign: return launch(inkernel_logp_kernel<kXorSign>, p, smem, stream);
    case kNoPrng: return launch(inkernel_logp_kernel<kNoPrng>, p, smem, stream);
    case kBlockDiag: return launch(inkernel_logp_kernel<kBlockDiag>, p, smem, stream);
    case kBf16: return launch(inkernel_logp_kernel<kBf16>, p, smem, stream);
    default: return kErrShape;
  }
}

// K7: out (n_rows,) = negative log-posterior and grad (n_rows, z_dim) = its
// z-gradient.  Arguments as for bnn_inkernel_logp, plus grad.
int bnn_inkernel_logp_and_grad(const float* z, const float* x, const float* y,
                               const float* v, const int* seed, float* out, float* grad,
                               int n_rows, int z_dim, int v_dim, int d0, int d1, int d2,
                               int binary, int fixed_mask, float sigma_v, float sigma_x,
                               float sigma_y, int block_rows, const int* n_layers,
                               const int* dims, const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, out, n_rows, z_dim, v_dim, d0, d1, d2,
                                binary, fixed_mask, sigma_v, sigma_x, sigma_y, block_rows,
                                n_layers, dims, ptrs);
  if (code != 0) return code;
  p.grad = grad;
  const size_t ws = p.words_stride, as = p.act_stride;
  const size_t us = 2 * as > ws ? 2 * as : ws;
  const size_t smem = sizeof(float) * (kTileRows * (2 * ws + (size_t)p.pre_stride + us) +
                                       2 * (size_t)p.wt_max + p.b_max +
                                       kTileRows * ((size_t)z_dim + 4));
  return launch(inkernel_grad_kernel, p, smem, stream);
}

// K5: n_steps MH steps from z with the proposal sd *q_sd (device memory):
// z_out (n_rows, z_dim), logp_out (n_rows,) = the last step's log-posterior
// of the state kept, counts (n_steps,) = accepted rows per step (zeroed
// here).  Other arguments as for bnn_inkernel_logp.
int bnn_inkernel_mh_steps(const float* z, const float* x, const float* y, const float* v,
                          const int* seed, const float* q_sd, float* z_out, float* logp_out,
                          float* counts, int n_rows, int z_dim, int v_dim, int d0, int d1,
                          int d2, int binary, int fixed_mask, float sigma_v, float sigma_x,
                          float sigma_y, int block_rows, int n_steps, const int* n_layers,
                          const int* dims, const void* const* ptrs, void* stream) {
  Params p;
  const int code = build_params(p, z, x, y, v, seed, logp_out, n_rows, z_dim, v_dim, d0, d1,
                                d2, binary, fixed_mask, sigma_v, sigma_x, sigma_y,
                                block_rows, n_layers, dims, ptrs);
  if (code != 0) return code;
  if (n_steps < 0) return kErrShape;
  p.q_sd = q_sd;
  p.z_out = z_out;
  p.counts = counts;
  p.n_steps = n_steps;
  size_t smem;
  const int setup = k5_setup(p, &smem);
  if (setup != 0) return setup;
  if (n_steps > 0) {
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(float) * n_steps,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return launch_k5(inkernel_mh_steps_kernel, p, smem, stream);
}

// out (rows, cols) uint32 = the sign words of `chain`/`group` for rows
// 0..rows-1 at evaluation ev.
int bnn_inkernel_sign_words(const int* seed, uint32_t* out, int rows, int cols, int chain,
                            int group, int ev, void* stream) {
  const long long n = (long long)rows * ((cols + 3) / 4);
  if (n <= 0) return 0;
  sign_words_kernel<<<grid_1d(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, rows, cols, chain, group, (uint32_t)ev);
  return (int)cudaGetLastError();
}

// out (n_blocks, rows, cols) f32 = layer `layer` of chain `chain`'s eps at
// evaluation ev in blocks 0..n_blocks-1.
int bnn_inkernel_eps(const int* seed, float* out, int n_blocks, int rows, int cols,
                     int chain, int layer, int ev, void* stream) {
  const long long n = (long long)n_blocks * ((rows * ((cols + 1) / 2) + 1) / 2);
  if (n <= 0) return 0;
  eps_kernel<<<grid_1d(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, n_blocks, rows, cols, chain, layer, (uint32_t)ev);
  return (int)cudaGetLastError();
}

// out (rows, z_dim) f32 = step `step`'s proposal normals.
int bnn_inkernel_proposal(const int* seed, float* out, int rows, int z_dim, int step,
                          void* stream) {
  const long long n = (long long)rows * ((((z_dim + 1) / 2) + 1) / 2);
  if (n <= 0) return 0;
  proposal_kernel<<<grid_1d(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(seed, out, rows,
                                                                         z_dim, step);
  return (int)cudaGetLastError();
}

// out (rows,) f32 = step `step`'s accept uniforms.
int bnn_inkernel_accept(const int* seed, float* out, int rows, int step, void* stream) {
  if (rows <= 0) return 0;
  accept_kernel<<<grid_1d(rows), 256, 0, static_cast<cudaStream_t>(stream)>>>(seed, out, rows, step);
  return (int)cudaGetLastError();
}

const char* bnn_inkernel_error_string(int code) {
  switch (code) {
    case kErrTooManyLayers: return "a chain has 0 or more than 20 layers";
    case kErrSmem: return "the tile's buffers for these widths do not fit in 227 KB of shared memory";
    case kErrShape: return "a layer width is < 1 or (K5, K6) over 4030, more than 256 weight panels (K5, K6), a chain's input or output width is wrong, n_steps < 0, or an unknown probe variant";
    case kErrBlockRows: return "block_rows must be a positive multiple of the kernel's 32-row tile";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
