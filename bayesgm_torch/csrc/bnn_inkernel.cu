// Flipout-BNN CausalBGM negative log-posterior with ALL noise drawn in the
// kernel: K6 (the value), K7 (the value and its z-gradient), K5 (n_steps
// random-walk MH steps in one launch) and K8 (the probe: K6 with one part
// switched out).
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
// with ev = 2 * step + side (side 0 the proposed state, 1 the current one; K6,
// K7 and K8 evaluate once, ev = 0).  A pair's u1, u2 are words 0, 1 (even
// pair) or 2, 3 (odd pair), uniforms from the high 24 bits; Box-Muller with
// u1 clamped at 1e-7 gives r cos(th) for column j and r sin(th) for column
// ceil(cols / 2) + j.  Built without --use_fast_math (logf, sqrtf, sincosf),
// so the normals match the plain version's to about 1e-6.
//
// What bounds them on an H100: the same f32 FMA work as K1 (139,392 flops
// per row and evaluation at the flagship width; K7 twice that), plus
// generating the weight noise.  Eps depends only on the logical block, but a
// block of 512 rows spans several tiles, and each tile regenerates its
// block's eps for every layer and every evaluation: ~34,848 normals per
// tile-evaluation, about one Philox call and one log, sqrt and sincos per two
// normals.  K5 pays it 2 * n_steps times, K7's backward once more.
//
// What the designs do about it.
// - K5's evaluation (k5_eval, "K5" below) is K1's register-tiled design
//   (csrc/bnn_hosteps.cu).  A tile of 64 rows (32 when block_rows is an odd
//   multiple of 32, so that a tile never straddles two logical blocks) keeps
//   its z, the proposal and logp in shared memory for the whole window and
//   reads x, y and v from device memory (20000 x 200 f32 stays in the 50 MB
//   L2 across the window); each step draws the proposal, evaluates both
//   sides, draws the accept uniform, updates z and adds the tile's accepts to
//   counts[step] (one atomicAdd per warp).  Each evaluation walks the layers
//   in panels of at most 64 output columns: loc and b through a ring of 3
//   cp.async slots, P = sigma * eps built into its slot from the eps counter
//   one panel ahead, 4 x 4 micro-tiles of both products over the tile's rows.
//   Shared memory at the flagship width: 51 KB of sign words, 4 x 16 KB of
//   activations, 3 x 33 KB of slots, 4 KB of error slots and 6.5 KB of tile
//   state (~221 KB): one block per SM.  What is left (NVIDIA H100,
//   tools/ablate_inkernel.py; PERF.md section 6): ~35.5 ms of device time per
//   50-step launch at 20000 rows, ~12 % of its bound; without the products'
//   inner loop ~23 % less, without P's build ~24 % less (a constant normal in
//   place of the draws ~16 % less), without the weight copies ~10 % less,
//   without the proposal and accept work no less.
// - K6 (inkernel_logp_eval_kernel<kBase>) is one evaluation (ev = 0) of K5's
//   in K5's tiles and shared memory: ~0.36 ms of device time at 20000 rows,
//   block_rows 512 (12 % of its bound).
// - K8 (inkernel_logp_eval_kernel<V>, bnn_inkernel_probe) is K6's own code
//   with one part switched out: the variant V is a template argument of
//   k5_eval and of everything it calls, and V = kBase is K6.  Per layer:
//     nopert    h @ loc + b: no P half in the slot, no P build, no second
//               product, no sign words
//     noeps     P = sigma * 0.01 (no Philox call), signs kept
//     epsref    P = sigma * loc, from the slot's own loc half, signs kept
//     nosigns   P = sigma * eps, no words filled: the signed copy is the
//               activations themselves and no r_out
//     noprng    noeps and nosigns together
//     xorsign   base, each sign applied by flipping the float's sign bit
//     blockdiag base's function as the literal product [h, h r_in] @
//               [[loc, 0], [0, P]] over 2 in ascending k, zero blocks
//               included (twice base's FMAs), in panels of at most 32 output
//               columns of each half, so that a block-diagonal panel
//               [2 in][2 x 32] fills one base slot and 3 slots still fit; a
//               32-wide panel takes 2 x 4 micro-tiles of both halves, whose
//               error slots (one per 16 columns, by shuffles) keep base's
//               count
//     bf16      base with h, h r_in, loc and P rounded to bf16 (round to
//               nearest even) and staged as bf16 (a slot holds half the
//               bytes), each widened before its f32 FMA: CUDA cores, not
//               tensor cores, so its time says nothing about a tensor-core
//               product
//   Every variant that draws uses K6's counters, so base, xorsign and
//   blockdiag see the noise K6 sees.
// - K7 has two forms, chosen by the host from the row count: up to
//   kK7ClusterMaxRows (768) rows a cluster of 8 CTAs per 32-row tile, past
//   it K5's register-tiled evaluation with a register-tiled backward.  Both
//   give K6's value bit for bit; no float atomics, so two launches give the
//   same bits.  See "K7" below for each form's design and shared memory.
//   What is left (NVIDIA H100 80GB HBM3, 700 W; tools/ablate_inkernel.py,
//   PERF.md section 6): the cluster form ~0.088 ms of device time at 32
//   rows (~0.006 of it the set-up, ~0.033 the backward; doubling its
//   cluster barriers adds ~0.013); the tiled form ~0.73 ms at 20000 rows,
//   block_rows 256 (11.5 % of its bound), ~0.37 without the backward, ~0.68
//   without P's build for the backward's panels or without the weight
//   copies.  One tile takes ~0.245 ms alone, and 313 tiles on 132 SMs run
//   in 3 rounds.  The switch: at 768 rows the cluster form takes ~0.17 ms
//   against the tiles' ~0.25, at 1024 ~0.25 against ~0.25.
// - Summation order.  K6 sums a row's squared error as k5_eval does: an
//   fmaf chain over each group of 4 columns, a 64-wide panel's 16 columns
//   of a slot as (g0 + g1) + (g2 + g3), the slots in ascending order; the
//   K7 cluster form repeats that order (k5_order_rows); every output is
//   (h @ loc + b) + signed((h r_in) @ P) with both products fmaf chains over
//   ascending k from 0.
// The launchers return kErrSmem when a shape does not fit, and refuse a
// block_rows that is not a multiple of 32 (kErrBlockRows).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 20;  // per chain (above 16, signs use word group 1)
constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // block_rows is a multiple of it; K7's cluster tile
constexpr int kCluster = 8;     // K7's CTAs per tile in its cluster form
// K7 takes its cluster form up to this many rows; past it, K5's register-tiled
// evaluation with a register-tiled backward (tools/ablate_inkernel.py).
constexpr int kK7ClusterMaxRows = 768;
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
// KERNEL_VARIANTS; K5 and K6 are kBase.  kGrad is K7's register-tiled form:
// kBase's arithmetic plus what its backward keeps; kGrad2 the same for
// layer inputs of 65 to 128 (two sets of backward accumulators).
enum Variant { kBase, kNoPert, kNoEps, kEpsRef, kNoSigns, kXorSign, kNoPrng, kBlockDiag, kBf16, kGrad, kGrad2 };

template <int V>
struct Probe {
  static constexpr bool kPert = V != kNoPert;  // the (h r_in) @ P product
  static constexpr bool kSigns = kPert && V != kNoSigns && V != kNoPrng;  // r_in, r_out
  static constexpr bool kNormals = V == kBase || V == kNoSigns || V == kXorSign ||
                                   V == kBlockDiag || V == kBf16 || V == kGrad ||
                                   V == kGrad2;  // eps drawn
  static constexpr bool kK7 = V == kGrad || V == kGrad2;  // K7's backward
  static constexpr int kNK = V == kGrad2 ? 2 : 1;         // its sets of accumulators
  static constexpr int kPCols = V == kBlockDiag ? 32 : 64;  // a panel's most output columns
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

// Four (two) consecutive staged operands, widened to f32; a bf16 widens to
// the f32 of its 16 bits followed by 16 zero bits.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// v[0 .. NR - 1] into NR consecutive staged operands.
template <int NR>
__device__ __forceinline__ void store_ops(float* p, const float (&v)[NR]) {
  if constexpr (NR == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (NR == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}
template <int NR>
__device__ __forceinline__ void store_ops(__nv_bfloat16* p, const float (&v)[NR]) {
  if constexpr (NR == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                                              bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
  } else if constexpr (NR == 2) {
    *reinterpret_cast<uint32_t*>(p) = bf16_bits(v[0]) | bf16_bits(v[1]) << 16;
  } else {
    p[0] = to_op<__nv_bfloat16>(v[0]);
  }
}

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
  int pre_off[kMaxLayers];  // K7: hidden layer i's first unit in the chain's tape
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
  int act_stride;    // max over chains of a layer's input width (K7 tiled: at least
                     // its last layers' panel widths)
  int pre_stride;    // max over chains of the summed hidden widths
  int tape_words;    // K7 tiled: ceil(pre_stride / 32)
  // K5's evaluation: its tile's rows, its weight panels in the order a tile
  // walks them (backward << 15 | chain << 12 | layer << 6 | panel; K7 tiled:
  // each chain's forward panels, then its hidden layers' again from the last,
  // marked backward), the ring's slots and the error slots per row
  int k5_rows, n_panels, n_stages, n_slots;
  uint16_t panel[256];
  // K7's cluster form: the largest per-CTA slices (floats) over the 8 CTAs
  int k7_w, k7_pre, k7_cols, k7_recv, k7_out;
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

// eps[k][j] of one layer's (in, out) draw for logical block blk at
// evaluation 0: the cosine or the sine of pair (k, j mod ceil(out / 2)).
__device__ __forceinline__ float eps_at(int blk, int chain, int layer, int out, int k, int j,
                                        uint2 key) {
  const int hc = (out + 1) >> 1;
  const int pidx = k * hc + (j < hc ? j : j - hc);
  const uint4 w = philox4x32_10(eps_counter(blk, pidx >> 1, 0u, chain, layer), key);
  float c, s;
  box_muller((pidx & 1) ? w.z : w.x, (pidx & 1) ? w.w : w.y, c, s);
  return j < hc ? c : s;
}

// K7's cluster form: words[r * stride + col] for the tile's 32 rows (0 past
// the valid rows).
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

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeakySlope * v; }

// Column k of chain ch's input for tile row r, before the frozen-BN affine: g
// takes z, h takes (z0, z2), f takes (z0, z1, x).
__device__ __forceinline__ float tile_input(const Params& p, int ch, const float* zt,
                                            const float* xt, int r, int k) {
  if (ch == 0) return zt[r * p.z_dim + k];
  if (ch == 1) return zt[r * p.z_dim + (k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0))];
  return k < p.d0 + p.d1 ? zt[r * p.z_dim + k] : xt[r];
}

// The z column that chain ch's input column k comes from (-1: f's x column).
__device__ __forceinline__ int z_col(const Params& p, int ch, int k) {
  if (ch == 1) return k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0);
  if (ch == 2 && k >= p.d0 + p.d1) return -1;
  return k;
}

constexpr int kK5Rows = 64;      // the row layout of K5's and K6's tile
constexpr int kPanelCols = 64;   // a weight panel: at most 64 output columns

// A panel of a layer `out` wide, of at most pc (64, blockdiag 32) output
// columns.  A layer of at most pc columns is one natural panel (local column
// = column).  A wider layer is cut into panels of pc / 2 Box-Muller pairs
// (pairs j0 .. j0 + pc / 2 - 1 of a row: columns j0 + c take their cosines,
// columns hc + j0 + c their sines), so that a Philox call's normals land in
// one panel and none is drawn twice: the panel's first wcos local columns
// are its cosine columns, the rest its sine columns.
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

__host__ __device__ __forceinline__ Panel panel_geom(int out, int pidx, int pc = kPanelCols) {
  Panel q;
  q.ch = q.layer = 0;
  q.hc = (out + 1) >> 1;
  q.paired = out > pc;
  if (!q.paired) {
    q.j0 = 0;
    q.ncos = q.hc;
    q.nsin = out - q.hc;
    q.wcos = (out + 3) & ~3;
    q.soff = q.hc;
    q.width = q.wcos;
  } else {
    q.j0 = (pc / 2) * pidx;
    q.ncos = min(pc / 2, q.hc - q.j0);
    q.nsin = max(0, min(pc / 2, out - q.hc - q.j0));
    q.wcos = (q.ncos + 3) & ~3;
    q.soff = q.wcos;
    q.width = q.wcos + ((q.nsin + 3) & ~3);
  }
  return q;
}

// Panels of a layer `out` wide.
__host__ __device__ __forceinline__ int panels_of(int out, int pc = kPanelCols) {
  return out <= pc ? 1 : ((out + 1) / 2 + pc / 2 - 1) / (pc / 2);
}

// Error slots a last-layer panel fills per row: one per 16 columns of a
// full-width panel, one per 4 columns of a narrower one.
__host__ __device__ __forceinline__ int panel_slots(const Panel& q, int pc = kPanelCols) {
  return q.width == pc ? pc / 16 : q.width / 4;
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

// The local column of layer column col, or -1 where the panel does not hold it.
__device__ __forceinline__ int panel_local(const Panel& q, int col) {
  if (!q.paired) return col < q.ncos + q.nsin ? col : -1;
  if (col >= q.j0 && col < q.j0 + q.ncos) return col - q.j0;
  const int s = col - q.hc - q.j0;
  return s >= 0 && s < q.nsin ? q.wcos + s : -1;
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
// from 0; 0 for rows from n_valid on), d(r, col) = target - output.  K7's
// cluster form repeats K6's order here: the block's threads form every row's
// slots into slots[r * n_slots + sl] (r fastest), then thread r adds its
// row's.  Call from every thread; the barrier between is inside.
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

// ---------------------------------------------------------------- K5 ----
//
// K5's evaluation, which K6 runs once and K8 runs with one part switched out
// (K1's design, csrc/bnn_hosteps.cu): 4 x 4 register micro-tiles over a
// 64-row layout, activations k-major with their sign-flipped copy written by
// the previous layer's epilogue, sign words column-major, and each layer's
// loc and b streamed in panels of at most 64 output columns through a ring
// of cp.async slots, one __syncthreads per panel.  P = sigma * eps of a panel
// is built from the eps counter into its slot one panel ahead, while the
// previous panel is in the FMAs; the stream of panels runs on across the
// window's 2 * n_steps evaluations.  A chain's last layer folds into per-row
// error slots: one per 16 columns of a 64-column panel (the 4 lanes that
// share a row quad reduce by shuffles), one per 4 columns of a narrower
// panel.

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

template <int V>
__device__ __forceinline__ Panel panel_at(const Params& p, int pc) {
  const int code = p.panel[pc];
  const int ch = (code >> 12) & 7, layer = (code >> 6) & 63;
  Panel q = panel_geom(p.chain[ch].dims[layer + 1], code & 63, Probe<V>::kPCols);
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

// A ring slot of variant V over act_stride as: loc[k][width] from its start,
// P[k][width] at `half` floats, then b[width] (nopert: no P half; bf16: both
// halves hold bf16, so half is half as many floats; blockdiag: the two halves
// hold the [2 in][2 width] block-diagonal panel).
template <int V>
__host__ __device__ __forceinline__ int k5_half(int as) {
  return V == kBf16 ? as * kPanelCols / 2 : as * kPanelCols;
}

template <int V>
__host__ __device__ __forceinline__ int k5_slot_floats(int as) {
  return (V == kNoPert ? 1 : 2) * k5_half<V>(as) + kPanelCols;
}

// This copies a panel's loc, sigma (at the P half, made P in place by
// k5_build_p) and b into its slot; columns the panel does not hold are 0.
// bf16 rounds loc as it stages it and leaves P's half 0 for k5_build_p,
// which reads sigma from device memory; blockdiag writes its zero blocks.
template <int V>
__device__ void k5_copy_panel(const Params& p, int pc, float* slot, int half) {
  const Panel q = panel_at<V>(p, pc);
  const Chain& c = p.chain[q.ch];
  const int in = c.dims[q.layer], out = c.dims[q.layer + 1];
  const float* loc = c.loc[q.layer];
  const float* sig = c.sig[q.layer];
  const float* b = c.b[q.layer];
  const int w = q.width;
  float* bs = slot + (V == kNoPert ? 1 : 2) * half;
  if constexpr (V == kBlockDiag) {
    // rows k: [loc | 0], rows in + k: [0 | sigma], each 2 w wide
    for (int idx = threadIdx.x; idx < in * w; idx += blockDim.x) {
      const int k = idx / w, cc = idx - k * w;
      float* top = slot + k * 2 * w;
      float* bot = slot + (in + k) * 2 * w;
      bool valid;
      const int col = panel_col(q, cc, valid);
      if (valid) {
        cp_async4(top + cc, loc + (size_t)k * out + col);
        cp_async4(bot + w + cc, sig + (size_t)k * out + col);
      } else {
        top[cc] = 0.f;
        bot[w + cc] = 0.f;
      }
      top[w + cc] = 0.f;
      bot[cc] = 0.f;
    }
  } else if constexpr (V == kBf16) {
    __nv_bfloat16* ls = reinterpret_cast<__nv_bfloat16*>(slot);
    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(slot + half);
    for (int idx = threadIdx.x; idx < in * w; idx += blockDim.x) {
      const int k = idx / w, cc = idx - k * w;
      bool valid;
      const int col = panel_col(q, cc, valid);
      ls[idx] = to_op<__nv_bfloat16>(valid ? __ldg(loc + (size_t)k * out + col) : 0.f);
      ps[idx] = to_op<__nv_bfloat16>(0.f);
    }
  } else {
    float* ls = slot;
    float* ss = slot + half;
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
        if constexpr (Probe<V>::kPert) cp_async16(ss + k * w + 4 * cc, sig + (size_t)k * out + 4 * cc);
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
          if constexpr (Probe<V>::kPert) cp_async4(ss + k * w + cc, sig + (size_t)k * out + col);
        } else {
          ls[k * w + cc] = 0.f;
          if constexpr (Probe<V>::kPert) ss[k * w + cc] = 0.f;
        }
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

// P[k][local c] of panel q = (the sigma its slot holds there) * e; bf16:
// sigma read from device memory and the product rounded into the bf16 half;
// blockdiag: the lower right block of its panel.
template <int V>
__device__ __forceinline__ void k5_put_p(const Params& p, const Panel& q, float* slot, int half,
                                         int in, int k, int c, float e) {
  if constexpr (V == kBlockDiag) {
    slot[(in + k) * 2 * q.width + q.width + c] *= e;
  } else if constexpr (V == kBf16) {
    bool valid;
    const int col = panel_col(q, c, valid);
    const float* sig = p.chain[q.ch].sig[q.layer];
    const int out = p.chain[q.ch].dims[q.layer + 1];
    reinterpret_cast<__nv_bfloat16*>(slot + half)[k * q.width + c] =
        to_op<__nv_bfloat16>(__ldg(sig + (size_t)k * out + col) * e);
  } else {
    slot[half + k * q.width + c] *= e;
  }
}

// Makes the P of panel pc in its slot: sigma * eps of panel pc's columns for
// logical block blk at evaluation ev (noeps and noprng: sigma * 0.01, epsref:
// sigma * loc, without a draw).  The draw is normal_quad's: pair (k, j) of
// the layer's (in, out) draw gives the cosine of column j and the sine of
// column hc + j.  A thread takes one Philox call of one row's pairs in the
// panel.
template <int V>
__device__ void k5_build_p(const Params& p, int pc, float* slot, int half, int blk, uint32_t ev,
                           uint2 key) {
  const Panel q = panel_at<V>(p, pc);
  const int in = p.chain[q.ch].dims[q.layer];
  if constexpr (!Probe<V>::kNormals) {
    float* ps = slot + half;
    for (int idx = threadIdx.x; idx < in * q.width; idx += blockDim.x)
      ps[idx] = ps[idx] * (V == kEpsRef ? slot[idx] : 0.01f);
  } else {
    const int hc = q.hc;
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
        k5_put_p<V>(p, q, slot, half, in, k, c, cs);
        if (c < q.nsin) k5_put_p<V>(p, q, slot, half, in, k, q.soff + c, sn);
      }
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
  // K7 (kGrad): a hidden layer's pre > 0 bits at unit unit0 + column of the
  // chain's tape [word][row]; on the last layer target - output of each mu
  // column (0 elsewhere, and for a binary head) at dbuf[local col][row], the
  // same with r_out at sbuf, and r_out of column cv_col (the one whose
  // cotangent is c_var) at rraw[row]
  uint32_t* tape;
  int unit0;
  float* dbuf;
  float* sbuf;
  float* rraw;
  int cv_col;
  bool no_d;
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
// tcol .. tcol + nv - 1 (local columns c0 .. c0 + 3): am, ap are their two
// products, bias the panel's b there.  On a last layer each row's error over
// them goes to sq[i] for the caller to reduce.
template <int V, int NR>
__device__ __forceinline__ void k5_epilogue(const K5Epi& e, int r0, int c0, int tcol, int nv,
                                            const float* bias, const float (&am)[NR][4],
                                            const float (&ap)[NR][4], const float (&tv)[NR][4],
                                            float (&sq)[NR]) {
  using T = typename Probe<V>::T;
  constexpr bool kSigns = Probe<V>::kSigns, kPert = Probe<V>::kPert;
  float pre[NR][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t w[NR];
    if constexpr (kSigns) {
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
    }
    float h[NR], hs[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      pre[i][j] = 0.f;
      if (j < nv) {
        float v = am[i][j] + bias[j];
        if constexpr (kSigns) {
          v = v + apply_sign<V>(ap[i][j], w[i], e.bit_out);
        } else if constexpr (kPert) {
          v = v + ap[i][j];
        }
        pre[i][j] = v;
        h[i] = leaky(v);
        if constexpr (kSigns) hs[i] = e.bit_next >= 0 ? apply_sign<V>(h[i], w[i], e.bit_next) : 0.f;
      }
    }
    if (e.nact != nullptr && j < nv) {
      store_ops<NR>(reinterpret_cast<T*>(e.nact) + (tcol + j) * kK5Rows + r0, h);
      if constexpr (kSigns)
        if (e.bit_next >= 0) store_ops<NR>(reinterpret_cast<T*>(e.nsgn) + (tcol + j) * kK5Rows + r0, hs);
    }
    if constexpr (Probe<V>::kK7) {
      if (e.nact == nullptr) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = r0 + i;
          const float d = !e.no_d && j < nv && tcol + j < e.d_mu && r < e.n_valid
                              ? tv[i][j] - pre[i][j]
                              : 0.f;
          e.dbuf[(c0 + j) * kK5Rows + r] = d;
          e.sbuf[(c0 + j) * kK5Rows + r] = j < nv ? apply_sign<V>(d, w[i], e.bit_out) : 0.f;
          if (j < nv && tcol + j == e.cv_col) e.rraw[r] = apply_sign<V>(1.f, w[i], e.bit_out);
        }
      }
    }
  }
  if constexpr (Probe<V>::kK7) {
    if (e.nact != nullptr) {
      // pre > 0 of units unit0 + tcol .. + nv - 1, one or two tape words per row
      const int u0 = e.unit0 + tcol, sh = u0 & 31;
      uint32_t* tw = e.tape + (u0 >> 5) * kK5Rows;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) m |= (j < nv && pre[i][j] > 0.f ? 1u : 0u) << j;
        if (m == 0u) continue;
        atomicOr(tw + r0 + i, m << sh);
        if (sh > 28 && (m >> (32 - sh)) != 0u) atomicOr(tw + kK5Rows + r0 + i, m >> (32 - sh));
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

// blockdiag's panel (at most 32 columns): [act | sgn] (2 in) @ its slot's
// [2 in][2 w] block-diagonal weight, w2 = [[loc, 0], [0, P]], every product
// over all 2 in rows of w2.  A 32-wide panel takes 2 x 4 micro-tiles of both
// halves (warp -> 8 rows, lane -> (row pair lane & 3, column quad lane >> 2))
// and adds a row's 4 column quads of each 16 columns by shuffles into one
// error slot; a narrower one 1 x 4 per thread.
template <int V, int NR>
__device__ __forceinline__ void k5_w2_tile(const Params& p, const K5Epi& e, const Panel& q,
                                           const float* act, const float* sgn, const float* w2,
                                           const float* bs, int r0, int c0, float (&sq)[NR]) {
  const int in = p.chain[q.ch].dims[q.layer], w = q.width, s2 = 2 * w;
  int nv;
  const int tcol = panel_quad(q, c0, nv);
  float am[NR][4], ap[NR][4], tv[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) am[i][j] = ap[i][j] = 0.f;
  k5_targets<NR>(p, e, r0, tcol, nv, tv);
  for (int half = 0; half < 2; ++half) {
    const float* a_src = half ? sgn : act;
    const float* wrow = w2 + half * in * s2;
#pragma unroll 4
    for (int k = 0; k < in; ++k) {
      float av[NR];
      if constexpr (NR == 2) {
        const float2 a = load2(a_src + k * kK5Rows + r0);
        av[0] = a.x, av[1] = a.y;
      } else {
        av[0] = a_src[k * kK5Rows + r0];
      }
      const float4 l = load4(wrow + k * s2 + c0);
      const float4 g = load4(wrow + k * s2 + w + c0);
      const float lv[4] = {l.x, l.y, l.z, l.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          am[i][j] = fmaf(av[i], lv[j], am[i][j]);
          ap[i][j] = fmaf(av[i], gv[j], ap[i][j]);
        }
    }
  }
  k5_epilogue<V, NR>(e, r0, c0, tcol, nv, bs + c0, am, ap, tv, sq);
}

// One panel of one layer for the tile's 64 rows, from act/sgn [k][row] and
// the panel's slot: 4 x 4 micro-tiles on a 64-wide panel, 2 x 4 on a
// 32-wide one, 1 x 4 on the others (blockdiag: k5_w2_tile).
template <int V>
__device__ __forceinline__ void k5_panel(const Params& p, const K5Epi& e, const Panel& q,
                                         const float* act_f, const float* sgn_f,
                                         const float* slot, int half) {
  using T = typename Probe<V>::T;
  constexpr bool kPert = Probe<V>::kPert;
  const T* act = reinterpret_cast<const T*>(act_f);
  const T* sgn = reinterpret_cast<const T*>(sgn_f);
  const int in = p.chain[q.ch].dims[q.layer], w = q.width;
  const T* ls = reinterpret_cast<const T*>(slot);
  const T* ps = reinterpret_cast<const T*>(slot + half);
  const float* bs = slot + (V == kNoPert ? 1 : 2) * half;
  const int tid = threadIdx.x;
  if constexpr (V == kBlockDiag) {
    if (w == 32) {
      const int warp = tid >> 5, lane = tid & 31;
      const int r0 = 8 * warp + 2 * (lane & 3), c0 = 4 * (lane >> 2);
      float sq[2];
      k5_w2_tile<V, 2>(p, e, q, act_f, sgn_f, slot, bs, r0, c0, sq);
      if (e.nact == nullptr) {
        // lanes 4 and 8 apart hold the row pair's other column quads of 16 columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 4);
          sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 8);
          if (((lane >> 2) & 3) == 0 && r0 + i < e.n_valid)
            e.groups[(r0 + i) * e.n_slots + e.slot0 + (lane >> 4)] = sq[i];
        }
      }
    } else {
      const int n_quads = w / 4;
      for (int t = tid; t < kK5Rows * n_quads; t += blockDim.x) {
        const int r = t % kK5Rows, c0 = 4 * (t / kK5Rows);
        float sq[1];
        k5_w2_tile<V, 1>(p, e, q, act_f, sgn_f, slot, bs, r, c0, sq);
        if (e.nact == nullptr && r < e.n_valid) e.groups[r * e.n_slots + e.slot0 + c0 / 4] = sq[0];
      }
    }
    return;
  }
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
      const float4 a = load4(act + k * kK5Rows + r0);
      const float4 l = load4(ls + k * kPanelCols + c0);
      const float av[4] = {a.x, a.y, a.z, a.w}, lv[4] = {l.x, l.y, l.z, l.w};
      if constexpr (kPert) {
        const float4 s = load4(sgn + k * kK5Rows + r0);
        const float4 g = load4(ps + k * kPanelCols + c0);
        const float sv[4] = {s.x, s.y, s.z, s.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            am[i][j] = fmaf(av[i], lv[j], am[i][j]);
            ap[i][j] = fmaf(sv[i], gv[j], ap[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) am[i][j] = fmaf(av[i], lv[j], am[i][j]);
      }
    }
    float sq[4];
    k5_epilogue<V, 4>(e, r0, c0, tcol, nv, bs + c0, am, ap, tv, sq);
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
      const float2 a = load2(act + k * kK5Rows + r0);
      const float4 l = load4(ls + k * w + c0);
      const float av[2] = {a.x, a.y}, lv[4] = {l.x, l.y, l.z, l.w};
      if constexpr (kPert) {
        const float2 s = load2(sgn + k * kK5Rows + r0);
        const float4 g = load4(ps + k * w + c0);
        const float sv[2] = {s.x, s.y}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            am[i][j] = fmaf(av[i], lv[j], am[i][j]);
            ap[i][j] = fmaf(sv[i], gv[j], ap[i][j]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) am[i][j] = fmaf(av[i], lv[j], am[i][j]);
      }
    }
    float sq[2];
    k5_epilogue<V, 2>(e, r0, c0, tcol, nv, bs + c0, am, ap, tv, sq);
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
        const float a = from_op(act[k * kK5Rows + r]);
        const float4 l = load4(ls + k * w + c0);
        am[0][0] = fmaf(a, l.x, am[0][0]);
        am[0][1] = fmaf(a, l.y, am[0][1]);
        am[0][2] = fmaf(a, l.z, am[0][2]);
        am[0][3] = fmaf(a, l.w, am[0][3]);
        if constexpr (kPert) {
          const float s = from_op(sgn[k * kK5Rows + r]);
          const float4 g = load4(ps + k * w + c0);
          ap[0][0] = fmaf(s, g.x, ap[0][0]);
          ap[0][1] = fmaf(s, g.y, ap[0][1]);
          ap[0][2] = fmaf(s, g.z, ap[0][2]);
          ap[0][3] = fmaf(s, g.w, ap[0][3]);
        }
      }
      float sq[1];
      k5_epilogue<V, 1>(e, r, c0, tcol, nv, bs + c0, am, ap, tv, sq);
      if (e.nact == nullptr && r < e.n_valid) e.groups[r * e.n_slots + e.slot0 + c0 / 4] = sq[0];
    }
  }
}

// sgn[k][r] = act[k][r] with r_in (bit `bit` of the words [k][r]) applied.
template <int V>
__device__ void k5_stage_sgn(const float* act_f, float* sgn_f, const uint32_t* words, int in,
                             int bit) {
  using T = typename Probe<V>::T;
  const T* act = reinterpret_cast<const T*>(act_f);
  T* sgn = reinterpret_cast<T*>(sgn_f);
  for (int idx = threadIdx.x; idx < kK5Rows * in; idx += blockDim.x)
    sgn[idx] = to_op<T>(apply_sign<V>(from_op(act[idx]), words[idx], bit));
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
  float* zp;        // K5: the proposal [64][z_dim]
  float* lp_prop;
  float* logp;
  int* accepted;
  uint32_t* tape;   // K7: pre > 0 bits of the chain's hidden units [word][64]
  float* dz;        // K7: [64][z_dim]
  float* s_row;     // K7: a row's variance of the chain's head (1 for a binary head)
  float* c_var;     // K7: the cotangent of column cv_col
  float* rraw;      // K7: r_out of column cv_col
  float* rm;        // K7: loc[k][cv_col] of the last layer, [act_stride]
  float* rp;        // K7: P[k][cv_col]
};

template <int V>
__host__ __device__ size_t k5_smem_floats(const Params& p, int n_stages) {
  const size_t R = kK5Rows, as = p.act_stride;
  size_t n = R * p.words_stride + 4 * R * as + n_stages * (size_t)k5_slot_floats<V>(as) +
             R * p.n_slots + 3 * R + R * p.z_dim;
  if (Probe<V>::kK7) {
    n += R * p.tape_words + R * p.z_dim + 3 * R + 2 * as;
  } else {
    n += R * p.z_dim + 3 * R;
  }
  return n;
}

template <int V>
__device__ K5Smem k5_carve(float* smem, const Params& p) {
  const int R = kK5Rows, as = p.act_stride, zd = p.z_dim;
  K5Smem s;
  s.words = reinterpret_cast<uint32_t*>(smem);
  s.act_buf = smem + R * p.words_stride;
  s.ring = s.act_buf + 4 * R * as;
  s.groups = s.ring + p.n_stages * k5_slot_floats<V>(as);
  s.loss = s.groups + R * p.n_slots;
  s.mu0 = s.loss + R;
  s.raw = s.mu0 + R;
  s.zt = s.raw + R;
  if constexpr (Probe<V>::kK7) {
    s.tape = reinterpret_cast<uint32_t*>(s.zt + R * zd);
    s.dz = reinterpret_cast<float*>(s.tape + R * p.tape_words);
    s.s_row = s.dz + R * zd;
    s.c_var = s.s_row + R;
    s.rraw = s.c_var + R;
    s.rm = s.rraw + R;
    s.rp = s.rm + as;
  } else {
    s.zp = s.zt + R * zd;
    s.lp_prop = s.zp + R * zd;
    s.logp = s.lp_prop + R;
    s.accepted = reinterpret_cast<int*>(s.logp + R);
  }
  return s;
}

// The window's stream of panels, one per ring slot: panel G of the stream is
// panel G % n_panels of evaluation G / n_panels.  With 3 slots, while panel
// G is in the FMAs, G + 1 is made P in place and G + 2 is being copied; with
// 2, panel G is made P after its copy lands (one more barrier).
template <int V>
struct K5Stream {
  int G, total, S, NP, half, slot_floats, blk;
  float* ring;
  uint2 key;

  __device__ __forceinline__ float* slot(int g) const { return ring + (g % S) * slot_floats; }

  __device__ __forceinline__ void copy(const Params& p, int g) const {
    if (g < total) k5_copy_panel<V>(p, g % NP, slot(g), half);
    cp_async_commit();
  }

  __device__ __forceinline__ void build(const Params& p, int g) const {
    if constexpr (Probe<V>::kPert)
      if (g < total) k5_build_p<V>(p, g % NP, slot(g), half, blk, (uint32_t)(g / NP), key);
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
template <int V>
__device__ __forceinline__ K5Stream<V> k5_stream(const Params& p, const K5Smem& s, int n_evals,
                                                 int row0, uint2 key) {
  K5Stream<V> st;
  st.G = 0;
  st.total = n_evals * p.n_panels;
  st.S = p.n_stages;
  st.NP = p.n_panels;
  st.half = k5_half<V>(p.act_stride);
  st.slot_floats = k5_slot_floats<V>(p.act_stride);
  st.blk = row0 / p.block_rows;
  st.ring = s.ring;
  st.key = key;
  return st;
}

// ---------------------------------------------------------------- K7 ----
//
// K7's two forms: the value of K6 and its z-gradient through the same draws
// (ev = 0).
//
// Past kK7ClusterMaxRows rows (inkernel_grad_tile_kernel): K5's evaluation
// (k5_eval<kGrad>, the same device code and order as K6, so the value is
// K6's bit for bit) with a register-tiled backward in K5's 64-row tiles.
// - The forward keeps one bit per hidden unit, pre > 0, in a tape of
//   ceil(hidden / 32) words per row (10 at the flagship width), set by the
//   epilogues with shared-memory atomicOr: the backward needs only the sign
//   of each pre-activation, since no weight gradient is wanted.
// - The last layer's backward runs inside its forward, panel by panel, while
//   its weights are in the slot: each panel's epilogue leaves target - output
//   of its mu columns (and that times r_out) in the activation buffers the
//   last layer does not write, and the block adds that panel's share of
//   d @ loc^T and (d r_out) @ P^T to per-thread accumulators; once every
//   panel is done the cotangent is -(that) / s + c_var (loc + r_in r_out P)
//   of the variance (or logit) column.  So the last layer's [out][rows]
//   cotangent (51 KB at the flagship width) is never stored and its panels
//   are not streamed twice.
// - Each hidden layer, from the last, streams its own forward panels again
//   (k5_copy_panel and k5_build_p with the same counters, so P comes from the
//   same draws and nothing is transposed on the host) and forms
//   cot @ loc^T + r_in ((cot r_out) @ P^T): a thread keeps 4 rows x 4 inputs
//   of both products across the layer's panels (256 threads x 16 = 64 x 64;
//   a second set of accumulators for inputs 65 .. 128 in kGrad2), four
//   output columns per step (16 float4 loads per 128 FMAs); a layer of at
//   most 16 (32) inputs splits its columns over 4 (2) groups of lanes (k7_map).
//   Then r_in and leaky' from the tape apply (gamma on the chain input,
//   scattered into dz).  The sign words are refilled where the backward
//   crosses a word group.
// - Shared memory at the flagship width: K5's carve-up without the window's
//   proposal buffers, plus the tape (2.5 KB), dz (2.5 KB) and per-row state
//   (224 KB in all, 3 ring slots): one block per SM.
//
// Up to kK7ClusterMaxRows rows (inkernel_grad_cluster_kernel), K2's cluster
// form (csrc/bnn_hosteps.cu) with in-kernel noise: one 32-row tile over a
// cluster of 8 CTAs.  CTA c owns a contiguous slice of every layer's output
// columns (c * width / 8 up to (c + 1) * width / 8) and at the start builds
// its slices of every layer's loc, b and P = sigma * eps, transposed to
// [column][k]: loc and b copied, P drawn from the eps counter for the tile's
// logical block, once for the launch, and used by both passes.  A slice's
// columns are contiguous, so a CTA draws the pairs that cover them and keeps
// the cosine or the sine it needs (each pair is drawn by at most two CTAs).
// Forward: each CTA computes its columns for all 32 rows (ascending k from 0
// for both products, as K6), keeps its pre-activations and writes the
// activations into every CTA's next buffer, one cluster.sync per layer; the
// last layer's outputs go to CTA 0, which sums the loss in K6's order
// (k5_order_rows) and forms the output cotangent.  Backward as K2's: per
// layer each CTA forms every input's partial sum over its columns and writes
// it to the input's owner, which adds the 8 partials in CTA order.
// Shared memory per CTA at the flagship width: ~36 KB of weight slices, ~162
// KB in all (the last layer's outputs and the tile's v sit in CTA 0's).

// K7's backward accumulators: a thread's 4 rows x 4 inputs of the two
// products, cot @ loc^T and (cot r_out) @ P^T; [1] for inputs 64 .. 127.
template <int NK>
struct K7Acc {
  float a[NK][4][4], b[NK][4][4];
};

// Which rows, inputs and columns a thread takes in K7's backward products of
// a layer with `in` inputs: row quad rq (rows 4 rq ..), input quad kq (and
// kq + 16), and every cs-th column quad from cg.  A layer of at most 16 (32)
// inputs has too few input quads for 256 threads, so its columns are split
// over cs = 4 (2) groups of lanes 8 (16) apart in one warp, whose partial
// sums k7_finish adds by shuffles.
struct K7Map {
  int rq, kq, cg, cs;
};

__device__ __forceinline__ K7Map k7_map(int in) {
  const int t = threadIdx.x;
  K7Map m;
  if (in <= 16) {
    m.cs = 4;
    m.cg = (t >> 3) & 3;
    m.rq = (t & 7) | ((t >> 2) & 8);
    m.kq = t >> 6;
  } else if (in <= 32) {
    m.cs = 2;
    m.cg = (t >> 4) & 1;
    m.rq = t & 15;
    m.kq = t >> 5;
  } else {
    m.cs = 1;
    m.cg = 0;
    m.rq = t & 15;
    m.kq = t >> 4;
  }
  return m;
}

template <int NK>
__device__ __forceinline__ void k7_zero(K7Acc<NK>& acc) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc.a[kk][i][m] = acc.b[kk][i][m] = 0.f;
}

// One panel's share of the backward products of a layer with `in` inputs:
// acc += cot @ loc^T and (cot r_out) @ P^T over the panel's columns, from
// the panel's slot.  kLocal: cot and cs are indexed by the panel's local
// column (the last layer's, formed by its epilogue); else by the layer's
// column ([out][64]).
template <bool kLocal, int NK>
__device__ __forceinline__ void k7_bwd_panel(const Params& p, const Panel& q, const float* slot,
                                             int half, const float* cot, const float* cs,
                                             K7Acc<NK>& acc) {
  const int w = q.width, in = p.chain[q.ch].dims[q.layer], out = p.chain[q.ch].dims[q.layer + 1];
  const K7Map mp = k7_map(in);
  const int r0 = 4 * mp.rq, kq = mp.kq;
  const float* ls = slot;
  const float* ps = slot + half;
  for (int c = 4 * mp.cg; c < w; c += 4 * mp.cs) {
    int col0 = c;
    if (!kLocal && q.paired) col0 = c < q.wcos ? q.j0 + c : q.hc + q.j0 + (c - q.wcos);
    float cv[4][4], sv[4][4];  // [column][row]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = kLocal ? c + jj : min(col0 + jj, out - 1);  // loc, P are 0 past the panel
      const float4 a = *reinterpret_cast<const float4*>(cot + col * kK5Rows + r0);
      const float4 s = *reinterpret_cast<const float4*>(cs + col * kK5Rows + r0);
      cv[jj][0] = a.x, cv[jj][1] = a.y, cv[jj][2] = a.z, cv[jj][3] = a.w;
      sv[jj][0] = s.x, sv[jj][1] = s.y, sv[jj][2] = s.z, sv[jj][3] = s.w;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (4 * (kq + 16 * kk) >= in) continue;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = min(4 * (kq + 16 * kk) + m, in - 1);
        const float4 l = *reinterpret_cast<const float4*>(ls + k * w + c);
        const float4 g = *reinterpret_cast<const float4*>(ps + k * w + c);
        const float lv[4] = {l.x, l.y, l.z, l.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc.a[kk][i][m] = fmaf(cv[jj][i], lv[jj], acc.a[kk][i][m]);
            acc.b[kk][i][m] = fmaf(sv[jj][i], gv[jj], acc.b[kk][i][m]);
          }
      }
    }
  }
}

// Layer i's input cotangent from the accumulators: a + r_in b (the last
// layer: -(a + r_in b) / s + c_var (loc + r_in r_out P) of column cv_col),
// then, for i > 0, times leaky' of layer i - 1 from the tape into cot_next
// [k][64] (and cs_next with r_out of layer i - 1, bit bit_next, unless it
// is -1), and for i = 0 times gamma, added into dz.
template <int NK>
__device__ __forceinline__ void k7_finish(const Params& p, const K5Smem& s, int ch, int i,
                                          bool last, K7Acc<NK>& acc, float* cot_next,
                                          float* cs_next, int bit_next, int n_valid) {
  const Chain& c = p.chain[ch];
  const int in = c.dims[i], bit_in = (2 * i) & 31;
  const K7Map mp = k7_map(in);
  const int r0 = 4 * mp.rq, kq = mp.kq;
  if (mp.cs > 1) {  // add the column groups' partial sums (one set of inputs)
    for (int d = 4 * 8 / mp.cs; d < 32; d *= 2) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc.a[0][ii][m] += __shfl_xor_sync(0xffffffffu, acc.a[0][ii][m], d);
          acc.b[0][ii][m] += __shfl_xor_sync(0xffffffffu, acc.b[0][ii][m], d);
        }
    }
    if (mp.cg != 0) return;
  }
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = 4 * (kq + 16 * kk) + m;
      if (k >= in) continue;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = r0 + ii;
        const uint32_t wd = s.words[k * kK5Rows + r];
        float g = acc.a[kk][ii][m] + apply_sign<kBase>(acc.b[kk][ii][m], wd, bit_in);
        if (last)
          g = -g / s.s_row[r] +
              s.c_var[r] * (s.rm[k] + apply_sign<kBase>(s.rraw[r] * s.rp[k], wd, bit_in));
        if (i > 0) {
          const int u = c.pre_off[i - 1] + k;
          g *= ((s.tape[(u >> 5) * kK5Rows + r] >> (u & 31)) & 1u) ? 1.f : kLeakySlope;
          cot_next[k * kK5Rows + r] = g;
          if (bit_next >= 0) cs_next[k * kK5Rows + r] = apply_sign<kBase>(g, wd, bit_next);
        } else if (r < n_valid) {
          const int col = z_col(p, ch, k);
          if (col >= 0) s.dz[r * p.z_dim + col] += g * c.gamma[k];
        }
      }
    }
  }
}

// K7's backward of chain ch after its forward and loss (k5_eval<kGrad>): the
// last layer's products are in acc; X is the pair of buffers the last layer
// read (free now), Y the one its epilogue filled.  Ends with a barrier.
template <int V>
__device__ __forceinline__ void k7_backward(const Params& p, const K5Smem& s, K5Stream<V>& st,
                                            int ch, int cur, int& group, uint32_t ev,
                                            K7Acc<Probe<V>::kNK>& acc, int row0, int n_valid) {
  const Chain& c = p.chain[ch];
  const int L = c.n_layers, R = kK5Rows, as = p.act_stride;
  float* X = s.act_buf + 2 * cur * R * as;
  float* Y = s.act_buf + 2 * (cur ^ 1) * R * as;
  auto bit_next = [&](int i) { return i > 0 && ((2 * i - 1) >> 5) == group ? (2 * i - 1) & 31 : -1; };
  k7_finish(p, s, ch, L - 1, true, acc, X, X + R * as, bit_next(L - 1), n_valid);
  for (int i = L - 2; i >= 0; --i) {
    // X holds the cotangent of layer i's outputs (and, unless the words
    // changed group, with r_out applied)
    if (((2 * i) >> 5) != group) {
      __syncthreads();
      group = (2 * i) >> 5;
      k5_fill_words(s.words, row0, n_valid, c.max_w, ch, group, ev, st.key);
      __syncthreads();
      k5_stage_sgn<V>(X, X + R * as, s.words, c.dims[i + 1], (2 * i + 1) & 31);
    }
    k7_zero(acc);
    const int n_pan = panels_of(c.dims[i + 1]);
    for (int j = 0; j < n_pan; ++j, ++st.G) {
      const float* slot = st.next(p);
      k7_bwd_panel<false>(p, panel_at<V>(p, st.G % st.NP), slot, st.half, X, X + R * as, acc);
    }
    k7_finish(p, s, ch, i, false, acc, Y, Y + R * as, bit_next(i), n_valid);
    float* t = X;
    X = Y;
    Y = t;
  }
  __syncthreads();
}

// ------------------------------------------------------------ k5_eval ----

// One evaluation of the tile's rows at the state zsrc (shared, [64][z_dim]):
// leaves in s.loss[r] the negative log-posterior of row r < n_valid (prior
// included).  It takes the stream's next panels; the evaluation is ev =
// st.G / n_panels.  V is K8's variant (kBase: K5 and K6); kGrad adds K7's
// backward after each chain, its z-gradient added into s.dz.
template <int V>
__device__ __forceinline__ void k5_eval(const Params& p, const K5Smem& s, const float* zsrc,
                                        int row0, int n_valid, K5Stream<V>& st) {
  using T = typename Probe<V>::T;
  constexpr bool kSigns = Probe<V>::kSigns;
  constexpr int kPC = Probe<V>::kPCols;
  const int tid = threadIdx.x, as = p.act_stride;
  const uint32_t ev = (uint32_t)(st.G / st.NP);
  __syncthreads();  // the previous evaluation's readers are done
  if (tid < kK5Rows) s.loss[tid] = 0.f;
  int cur = 0;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    int group = 0;
    if constexpr (kSigns) k5_fill_words(s.words, row0, n_valid, c.max_w, ch, 0, ev, st.key);
    const int in0 = c.dims[0];
    T* act = reinterpret_cast<T*>(s.act_buf + 2 * cur * kK5Rows * as);
    for (int idx = tid; idx < kK5Rows * in0; idx += blockDim.x) {
      const int k = idx / kK5Rows, r = idx - k * kK5Rows;
      act[idx] = to_op<T>(r < n_valid ? tile_input(p, ch, zsrc, p.x + row0, r, k) * c.gamma[k] + c.beta[k]
                                      : 0.f);
    }
    if constexpr (Probe<V>::kK7)
      for (int idx = tid; idx < kK5Rows * p.tape_words; idx += blockDim.x) s.tape[idx] = 0u;
    __syncthreads();
    if constexpr (kSigns)
      k5_stage_sgn<V>(s.act_buf + 2 * cur * kK5Rows * as, s.act_buf + (2 * cur + 1) * kK5Rows * as,
                      s.words, in0, 0);

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
    e.bit_next = -1;
    K7Acc<Probe<V>::kNK> acc;
    if constexpr (Probe<V>::kK7) {
      e.tape = s.tape;
      e.rraw = s.rraw;
      e.no_d = ch == 1 && p.binary;
      e.cv_col = e.no_d ? 0 : e.d_mu;
    }
    int n_sl = 0;  // the last layer's error slots
    for (int i = 0; i < c.n_layers; ++i) {
      const bool last = i == c.n_layers - 1;
      const int out = c.dims[i + 1];
      const float* a = s.act_buf + 2 * cur * kK5Rows * as;
      float* na = s.act_buf + 2 * (cur ^ 1) * kK5Rows * as;
      const bool same_group = !last && ((2 * (i + 1)) >> 5) == group;
      e.bit_out = (2 * i + 1) & 31;
      if constexpr (kSigns) e.bit_next = same_group ? (2 * (i + 1)) & 31 : -1;
      e.nact = last ? nullptr : na;
      e.nsgn = na + kK5Rows * as;
      if constexpr (Probe<V>::kK7) {
        e.unit0 = c.pre_off[i];
        e.dbuf = na;
        e.sbuf = na + kK5Rows * as;
        if (last) k7_zero(acc);
      }
      const int n_pan = panels_of(out, kPC);
      for (int j = 0; j < n_pan; ++j, ++st.G) {
        const float* slot = st.next(p);
        const Panel q = panel_at<V>(p, st.G % st.NP);
        e.slot0 = n_sl;
        k5_panel<V>(p, e, q, a, kSigns ? a + kK5Rows * as : a, slot, st.half);
        if (last) n_sl += panel_slots(q, kPC);
        if constexpr (Probe<V>::kK7) {
          if (last) {
            __syncthreads();  // the panel's d and d r_out are complete
            k7_bwd_panel<true>(p, q, slot, st.half, e.dbuf, e.sbuf, acc);
            const int lc = panel_local(q, e.cv_col);
            if (lc >= 0) {
              for (int k = tid; k < c.dims[i]; k += blockDim.x) {
                s.rm[k] = slot[k * q.width + lc];
                s.rp[k] = slot[st.half + k * q.width + lc];
              }
            }
          }
        }
      }
      if (!last) {
        cur ^= 1;
        if constexpr (kSigns) {
          if (!same_group) {
            __syncthreads();
            group = (2 * (i + 1)) >> 5;
            k5_fill_words(s.words, row0, n_valid, c.max_w, ch, group, ev, st.key);
            __syncthreads();
            k5_stage_sgn<V>(na, na + kK5Rows * as, s.words, out, (2 * (i + 1)) & 31);
          }
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
        if constexpr (Probe<V>::kK7) {
          s.s_row[tid] = 1.f;
          s.c_var[tid] = sigmoid(lx) - xr;
        }
      } else {
        const bool fixed = (p.fixed_mask >> ch) & 1;
        const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
        const float sv = fixed ? sigma * sigma : softplus(s.raw[tid]) + kEpsF;
        const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
        l += sq / (2.f * sv) + n_dims * logf(sv) / 2.f;
        if constexpr (Probe<V>::kK7) {
          s.s_row[tid] = sv;
          s.c_var[tid] =
              fixed ? 0.f : (-sq / (2.f * (sv * sv)) + n_dims / (2.f * sv)) * sigmoid(s.raw[tid]);
        }
      }
      s.loss[tid] = l;
    } else if (Probe<V>::kK7 && tid < kK5Rows) {
      s.s_row[tid] = 1.f;
      s.c_var[tid] = 0.f;
    }
    __syncthreads();  // before the next chain refills the words
    if constexpr (Probe<V>::kK7) k7_backward<V>(p, s, st, ch, cur, group, ev, acc, row0, n_valid);
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
  const K5Smem s = k5_carve<kBase>(reinterpret_cast<float*>(smem4), p);

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = blockIdx.x * p.k5_rows;
  const int n_valid = min(p.k5_rows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const float q_sd = *p.q_sd;
  K5Stream<kBase> st = k5_stream<kBase>(p, s, 2 * p.n_steps, row0, key);

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
      k5_eval<kBase>(p, s, side == 0 ? s.zp : s.zt, row0, n_valid, st);
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

// K6 (V = kBase) and K8's variant V: out[row] = the negative log-posterior,
// one evaluation (ev = 0) of K5's (k5_eval) for the tile's k5_rows rows (64,
// or 32 when block_rows is an odd multiple of 32), their z copied into
// shared memory first.
template <int V>
__global__ void __launch_bounds__(kThreads, 1) inkernel_logp_eval_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int R = kK5Rows, zd = p.z_dim;
  const K5Smem s = k5_carve<V>(reinterpret_cast<float*>(smem4), p);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.k5_rows;
  const int n_valid = min(p.k5_rows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  K5Stream<V> st = k5_stream<V>(p, s, 1, row0, key);
  for (int idx = tid; idx < R * zd; idx += blockDim.x)
    s.zt[idx] = idx / zd < n_valid ? p.z[(size_t)row0 * zd + idx] : 0.f;
  st.prologue(p);
  k5_eval<V>(p, s, s.zt, row0, n_valid, st);
  cp_async_wait<0>();
  if (tid < n_valid) p.out[row0 + tid] = s.loss[tid];
}

// K7 past kK7ClusterMaxRows rows: k5_eval<V> (V = kGrad, or kGrad2 for
// layer inputs past 64: K6's value with the backward after each chain) for
// the tile's k5_rows rows.
template <int V>
__global__ void __launch_bounds__(kThreads, 1) inkernel_grad_tile_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int R = kK5Rows, zd = p.z_dim;
  const K5Smem s = k5_carve<V>(reinterpret_cast<float*>(smem4), p);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.k5_rows;
  const int n_valid = min(p.k5_rows, p.n_rows - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  K5Stream<V> st = k5_stream<V>(p, s, 1, row0, key);
  for (int idx = tid; idx < R * zd; idx += blockDim.x) {
    s.zt[idx] = idx / zd < n_valid ? p.z[(size_t)row0 * zd + idx] : 0.f;
    s.dz[idx] = 0.f;
  }
  st.prologue(p);
  k5_eval<V>(p, s, s.zt, row0, n_valid, st);
  cp_async_wait<0>();
  if (tid < n_valid) p.out[row0 + tid] = s.loss[tid];
  for (int idx = tid; idx < n_valid * zd; idx += blockDim.x)
    p.grad[(size_t)row0 * zd + idx] = s.dz[idx] + s.zt[idx];
}

// ----------------------------------------------------- K7's cluster form ----

__host__ __device__ __forceinline__ int slice_start(int width, int c) { return width * c / kCluster; }

// The CTA that owns column k of a layer `width` wide.
__device__ __forceinline__ int slice_owner(int width, int k) {
  int o = 0;
  while (o + 1 < kCluster && slice_start(width, o + 1) <= k) ++o;
  return o;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
inkernel_grad_cluster_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int R = kTileRows;
  const int rank = (int)cluster.block_rank();
  const int ws = (p.words_stride + 3) & ~3, as = p.act_stride, rw = p.k7_recv;
  float* W = smem;
  uint32_t* words = reinterpret_cast<uint32_t*>(W + p.k7_w);  // [row][col]
  float* act = reinterpret_cast<float*>(words + R * ws);     // 2 x [k][row]
  float* pre = act + 2 * R * as;                             // own hidden pre-activations
  float* cot = pre + p.k7_pre;                               // own cotangent slice [col][row]
  float* recv = cot + R * p.k7_cols;                         // 2 x [src CTA][own col][row]
  float* full = recv + 2 * kCluster * R * rw;                // CTA 0: last layer [col][row]
  float* dz = full + R * p.k7_out;                           // CTA 0: [row][z col]
  float* slots = dz + R * p.z_dim;                           // CTA 0: error slots [row][n_slots]
  float* vt = slots + R * p.n_slots;                         // CTA 0: the tile's v [row][col]
  float* loss = vt + R * p.v_dim;
  float* sq = loss + R;
  float* s_row = sq + R;
  float* c_var = s_row + R;
  int* woff = reinterpret_cast<int*>(c_var + R);  // [ch * kMaxLayers + i]
  int* poff = woff + 3 * kMaxLayers;

  const int tile = blockIdx.x / kCluster;
  const int row0 = tile * R;
  const int n_valid = min(R, p.n_rows - row0);
  const int blk = row0 / p.block_rows;
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x;
  const float* zt = p.z + (size_t)row0 * p.z_dim;

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
          wp[idx] = c.sig[i][(size_t)k * out + j0 + jl] * eps_at(blk, ch, i, out, k, j0 + jl, key);
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
    fill_words(words, ws, row0, n_valid, c.max_w, ch, 0, 0u, key);
    float* a0 = act + cur * R * as;
    for (int idx = tid; idx < R * in0; idx += blockDim.x) {
      const int k = idx / R, r = idx - k * R;
      a0[idx] = r < n_valid ? tile_input(p, ch, zt, p.x + row0, r, k) * c.gamma[k] + c.beta[k] : 0.f;
    }
    __syncthreads();

    // Forward.
    for (int i = 0; i < n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == n_layers - 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        fill_words(words, ws, row0, n_valid, c.max_w, ch, group, 0u, key);
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
          ap = fmaf(apply_sign<kBase>(h0, w.x, bit_in), g.x, ap);
          am = fmaf(h1, l.y, am);
          ap = fmaf(apply_sign<kBase>(h1, w.y, bit_in), g.y, ap);
          am = fmaf(h2, l.z, am);
          ap = fmaf(apply_sign<kBase>(h2, w.z, bit_in), g.z, ap);
          am = fmaf(h3, l.w, am);
          ap = fmaf(apply_sign<kBase>(h3, w.w, bit_in), g.w, ap);
        }
        for (; k < in; ++k) {
          const float h = a[k * R + r];
          am = fmaf(h, lrow[k], am);
          ap = fmaf(apply_sign<kBase>(h, wrow[k], bit_in), prow[k], ap);
        }
        const float v = (am + wb[jl]) + apply_sign<kBase>(ap, words[r * ws + j], bit_out);
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

    // CTA 0: the chain's likelihood term, its squared error in K6's order,
    // and its output cotangent.
    const int d_mu = ch == 0 ? p.v_dim : 1;
    const int out_last = c.dims[n_layers];
    const bool binary_head = ch == 1 && p.binary;
    if (rank == 0) {
      auto target = [&](int r, int col) {
        return ch == 0 ? vt[r * p.v_dim + col] : (ch == 1 ? p.x[row0 + r] : p.y[row0 + r]);
      };
      k5_order_rows(out_last, d_mu, R, n_valid, p.n_slots, slots, sq,
                    [&](int r, int col) { return target(r, col) - full[col * R + r]; });
      if (tid < R) {
        float sv = 1.f, cv = 0.f;
        if (tid < n_valid) {
          float l = loss[tid];
          if (binary_head) {
            const float lx = full[tid];
            const float xr = p.x[row0 + tid];
            l += fmaxf(lx, 0.f) - lx * xr + log1pf(expf(-fabsf(lx)));
            cv = sigmoid(lx) - xr;
          } else {
            const bool fixed = (p.fixed_mask >> ch) & 1;
            const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
            const float raw = full[d_mu * R + tid];
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
      for (int idx = tid; idx < R * out_last; idx += blockDim.x) {
        const int col = idx / R, r = idx - col * R;
        float cval = 0.f;
        if (r < n_valid) {
          if (binary_head) {
            cval = col == 0 ? c_var[r] : 0.f;
          } else if (col < d_mu) {
            cval = -(target(r, col) - full[idx]) / s_row[r];
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
        fill_words(words, ws, row0, n_valid, c.max_w, ch, group, 0u, key);
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
          const float cs = apply_sign<kBase>(cv, words[r * ws + j0 + jl], bit_out);
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
          const float part = g1[m] + apply_sign<kBase>(g2[m], wk[m], bit_in);
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
          float g = 0.f;
          for (int src = 0; src < kCluster; ++src) g += rv[src * rw * R + idx];
          cot[idx] = g * (pr[idx] > 0.f ? 1.f : kLeakySlope);
        }
        __syncthreads();
      } else if (rank == 0) {
        // The chain-input gradient, scattered into dz.
        for (int idx = tid; idx < R * in0; idx += blockDim.x) {
          const int k = idx / R, r = idx - k * R;
          const int col = z_col(p, ch, k);
          if (r >= n_valid || col < 0) continue;
          float g = 0.f;
          for (int src = 0; src < kCluster; ++src) g += rv[src * rw * R + idx];
          dz[r * p.z_dim + col] += g * c.gamma[k];
        }
        __syncthreads();
      }
      par ^= 1;
    }
  }

  if (rank == 0) {
    if (tid < n_valid) {
      float zz = 0.f;
      for (int k = 0; k < p.z_dim; ++k) {
        const float zk = zt[tid * p.z_dim + k];
        zz = fmaf(zk, zk, zz);
      }
      p.out[row0 + tid] = loss[tid] + zz / 2.f;
    }
    for (int idx = tid; idx < R * p.z_dim; idx += blockDim.x) {
      const int r = idx / p.z_dim;
      if (r < n_valid) {
        const size_t g_idx = (size_t)row0 * p.z_dim + idx;
        p.grad[g_idx] = dz[idx] + p.z[g_idx];
      }
    }
  }
}

// ----------------------------------------------------------- the draws ----

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

// ---------------------------------------------------------------- host ----

// Fill the parts of Params that K5-K8 share from the C arguments; returns 0
// or one of the negative codes above.
int build_params(Params& p, const float* z, const float* x, const float* y, const float* v,
                 const int* seed, float* out, int n_rows, int z_dim, int v_dim, int d0,
                 int d1, int d2, int binary, int fixed_mask, float sigma_v, float sigma_x,
                 float sigma_y, int block_rows, const int* n_layers, const int* dims,
                 const void* const* ptrs) {
  p = Params{};
  int di = 0, pi = 0;
  p.words_stride = p.act_stride = p.pre_stride = 1;
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
      if (c.dims[i] > p.act_stride) p.act_stride = c.dims[i];
      c.pre_off[i] = pre_cols;
      if (i < c.n_layers - 1) pre_cols += c.dims[i + 1];
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

int grid_1d(long long n) { return (int)((n + 255) / 256); }

// K5's evaluation for variant V: the tile's rows, the weight panels in the
// order a tile walks them (kGrad: each chain's forward panels, then its
// hidden layers' from the last), the error slots per row and the ring's
// slots (3, or 2 where 3 do not fit).  kGrad also widens act_stride to its
// last layers' panels (their epilogues' d and d r_out land in activation
// buffers) and sizes the tape.  Returns 0, kErrShape or kErrSmem; *smem
// gets the bytes of shared memory.
template <int V>
int k5_setup(Params& p, size_t* smem) {
  constexpr int pc = Probe<V>::kPCols;
  p.k5_rows = p.block_rows % kK5Rows == 0 ? kK5Rows : kTileRows;  // a tile lies in one block
  p.n_panels = 0;
  p.n_slots = 1;
  auto push = [&](int ch, int i, int bwd) {
    const int n_pan = panels_of(p.chain[ch].dims[i + 1], pc);
    if (n_pan > 63 || p.n_panels + n_pan > 256) return false;
    for (int j = 0; j < n_pan; ++j)
      p.panel[p.n_panels++] = (uint16_t)(bwd << 15 | ch << 12 | i << 6 | j);
    return true;
  };
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    for (int i = 0; i < c.n_layers; ++i)
      if (!push(ch, i, 0)) return kErrShape;
    if (Probe<V>::kK7)
      for (int i = c.n_layers - 2; i >= 0; --i)
        if (!push(ch, i, 1)) return kErrShape;
    const int out = c.dims[c.n_layers];
    int n_sl = 0;
    for (int j = 0; j < panels_of(out, pc); ++j) {
      const Panel q = panel_geom(out, j, pc);
      n_sl += panel_slots(q, pc);
      if (Probe<V>::kK7 && q.width > p.act_stride) p.act_stride = q.width;
    }
    if (n_sl > p.n_slots) p.n_slots = n_sl;
  }
  if (Probe<V>::kK7) p.tape_words = (p.pre_stride + 31) / 32;
  p.n_stages = sizeof(float) * k5_smem_floats<V>(p, 3) <= (size_t)kMaxSmemBytes ? 3 : 2;
  *smem = sizeof(float) * k5_smem_floats<V>(p, p.n_stages);
  if (*smem > (size_t)kMaxSmemBytes) return kErrSmem;
  // K7's backward takes inputs up to 64 in kGrad and up to 128 in kGrad2
  // (wider ones never fit in shared memory)
  return Probe<V>::kK7 && p.act_stride > Probe<V>::kNK * kK5Rows ? kErrShape : 0;
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

template <int V>
int launch_eval(Params& p, void* stream) {
  size_t smem;
  const int setup = k5_setup<V>(p, &smem);
  if (setup != 0) return setup;
  return launch_k5(inkernel_logp_eval_kernel<V>, p, smem, stream);
}

int host_slice(int width, int c) { return slice_start(width, c + 1) - slice_start(width, c); }

// K7's cluster form: the largest slices over its CTAs and the bytes of
// shared memory per CTA.
size_t k7_cluster_setup(Params& p) {
  p.k7_w = p.k7_pre = 0;
  p.k7_recv = p.k7_cols = p.k7_out = 1;
  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    if (c.dims[0] > p.k7_recv) p.k7_recv = c.dims[0];
    if (c.dims[c.n_layers] > p.k7_out) p.k7_out = c.dims[c.n_layers];
  }
  for (int rank = 0; rank < kCluster; ++rank) {
    int w = 0;
    for (int ch = 0; ch < 3; ++ch) {
      const Chain& c = p.chain[ch];
      int pre = 0;
      for (int i = 0; i < c.n_layers; ++i) {
        const int ns = host_slice(c.dims[i + 1], rank);
        w += ((2 * ((c.dims[i] + 3) & ~3) + 1) * ns + 3) & ~3;
        if (i < c.n_layers - 1) pre += kTileRows * ns;
        if (ns > p.k7_cols) p.k7_cols = ns;
        if (i > 0 && host_slice(c.dims[i], rank) > p.k7_recv) p.k7_recv = host_slice(c.dims[i], rank);
      }
      if (pre > p.k7_pre) p.k7_pre = pre;
    }
    if (w > p.k7_w) p.k7_w = w;
  }
  const size_t R = kTileRows;
  return sizeof(float) * ((size_t)p.k7_w + R * ((p.words_stride + 3) & ~3) + 2 * R * p.act_stride +
                          p.k7_pre + R * p.k7_cols + 2 * kCluster * R * p.k7_recv + R * p.k7_out +
                          R * p.z_dim + R * p.n_slots + R * p.v_dim + 4 * R) +
         sizeof(int) * 6 * kMaxLayers;
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
  return launch_eval<kBase>(p, stream);
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
  switch (variant) {
    case kBase: return launch_eval<kBase>(p, stream);
    case kNoPert: return launch_eval<kNoPert>(p, stream);
    case kNoEps: return launch_eval<kNoEps>(p, stream);
    case kEpsRef: return launch_eval<kEpsRef>(p, stream);
    case kNoSigns: return launch_eval<kNoSigns>(p, stream);
    case kXorSign: return launch_eval<kXorSign>(p, stream);
    case kNoPrng: return launch_eval<kNoPrng>(p, stream);
    case kBlockDiag: return launch_eval<kBlockDiag>(p, stream);
    case kBf16: return launch_eval<kBf16>(p, stream);
    default: return kErrShape;
  }
}

// K7: out (n_rows,) = negative log-posterior and grad (n_rows, z_dim) = its
// z-gradient.  Arguments as for bnn_inkernel_logp, plus grad.  Up to
// kK7ClusterMaxRows rows a cluster of 8 CTAs takes each 32-row tile; past it
// K5's tiles do (each form where the other does not fit).
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
  const size_t smem_cluster = k7_cluster_setup(p);
  Params pt = p;
  size_t smem_tile = 0;
  const int tile_setup = k5_setup<kGrad2>(pt, &smem_tile);  // kGrad's set-up too
  const bool cluster_fits = smem_cluster <= (size_t)kMaxSmemBytes;
  if (!cluster_fits && tile_setup != 0) return tile_setup;
  if (n_rows <= 0) return 0;
  if (cluster_fits && (n_rows <= kK7ClusterMaxRows || tile_setup != 0)) {
    cudaError_t err = cudaFuncSetAttribute(inkernel_grad_cluster_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_cluster);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n_rows + kTileRows - 1) / kTileRows;
    inkernel_grad_cluster_kernel<<<tiles * kCluster, kThreads, smem_cluster,
                                   static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
  if (pt.act_stride > kK5Rows) return launch_k5(inkernel_grad_tile_kernel<kGrad2>, pt, smem_tile, stream);
  return launch_k5(inkernel_grad_tile_kernel<kGrad>, pt, smem_tile, stream);
}

// The row count up to which K7 takes its cluster form.
int bnn_inkernel_grad_cluster_max_rows() { return kK7ClusterMaxRows; }

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
  const int setup = k5_setup<kBase>(p, &smem);
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
    case kErrShape: return "a layer width is < 1 or (K5-K8) over 4030, more than 256 weight panels (K5-K8), a layer input over 128 (K7 past its cluster form), a chain's input or output width is wrong, n_steps < 0, or an unknown probe variant";
    case kErrBlockRows: return "block_rows must be a positive multiple of the kernel's 32-row tile";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
