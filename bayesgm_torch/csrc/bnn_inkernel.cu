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
// noise.  Eps depends only on the logical block, but blocks of 512 rows span
// 16 tiles of 32, and each tile regenerates its block's eps for every layer
// and every evaluation: ~34,848 normals per tile-evaluation, about one
// Philox call and one log, sqrt and sincos per two normals.  That redundant
// work is what K6 costs beyond K1, and K5 pays it 2 * n_steps times.
//
// What the design does about it: K1's tile (8 warps x 4 rows, 32 rows), its
// per-layer staging of loc and the last layer folded into the loss, but
// instead of loading P the tile builds P = sigma * eps for its block in
// shared memory, layer by layer, from the eps counter (no storage; K7
// regenerates P again on its way back instead of keeping it).  K7 is K2's
// design (tape of pre-activations, odd-stride transposed staging, gradient
// scatter, prior + z) with the same P generation.  K5 keeps a tile's z, x, y
// and v (32 x 200 f32 = 25.6 KB) and its logp in shared memory for the
// whole window, so x, y and v are read from device memory once per launch,
// not 2 * n_steps times; each step draws the proposal, evaluates both sides
// through K6's device code, draws the accept uniform, updates z and adds the
// tile's accept count to counts[step] with one atomicAdd.  Shared memory at
// the flagship width: K6 ~155 KB, K5 ~183 KB (K6's plus 28.8 KB of tile
// state), K7 ~219 KB, all under the 227 KB a block may use; the launchers
// return kErrSmem when a shape does not fit.  The tile of 32 rows must lie in
// one logical block, so block_rows must be a multiple of 32 (kErrBlockRows).
// Sharing eps across the tiles of a block (a cluster, or a per-block scratch
// in device memory), register tiling and pipelined staging are later work.
//
// K8 (bnn_inkernel_probe) replaces benchmarks/mxu_probe.py::make_probe_kernel,
// the probe that times K6's evaluation with one part switched out; its plain
// version is bayesgm_torch/benchmarks/mxu_probe.py::probe_plain.  The variant
// is a template argument of K6's device code (tile_neg_logp, build_p), one
// __global__ instantiation each; K5, K6 and K7 run kBase.  Per layer:
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
// blockdiag see the noise K6 sees.  What bounds K8 is what bounds K6; the
// variants measure how much of K6's time each part costs.

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

// One evaluation's shared-memory buffers (K6, and K5 twice per step).
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
  float* o2;  // K8 blockdiag: the tile's 2 out product columns, row stride 2 b_max
};

__host__ __device__ size_t eval_smem_floats(const Params& p, bool blockdiag = false) {
  return (size_t)kTileRows * p.words_stride + 3 * (size_t)kTileRows * p.act_stride +
         2 * (size_t)p.w_max + p.b_max + 4 * kTileRows +
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
  s.o2 = s.raw + kTileRows;
  return s;
}

// K6's device code: leaves in s.loss[r] the negative log-posterior of tile
// row r < n_valid (prior included; 0 for the other rows).  The tile's rows
// are read from zt (stride z_dim), xt, yt and vt (stride v_dim), in device
// or shared memory; blk is the rows' logical block, ev the evaluation.  V is
// K8's variant (kBase for K5 and K6).
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
      float sq_acc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) sq_acc[j] = 0.f;
      // Column col of the warp's rows: am the loc product, ap the
      // perturbation product before r_out.
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
              const float d = t - pre;
              sq_acc[j] = fmaf(d, d, sq_acc[j]);
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
      if (last) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          float a = sq_acc[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (lane == 0) s.sq[warp * kRowsPerWarp + j] = a;
        }
      }
      __syncthreads();
      float* t = act;
      act = nxt;
      nxt = t;
    }

    // Fold this chain's likelihood term into the row's loss.
    if (tid < n_valid) {
      float l = s.loss[tid];
      if (ch == 1 && p.binary) {
        const float lx = s.mu0[tid];
        l += fmaxf(lx, 0.f) - lx * xt[tid] + log1pf(expf(-fabsf(lx)));
      } else {
        const bool fixed = (p.fixed_mask >> ch) & 1;
        const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
        const float sv = fixed ? sigma * sigma : softplus(s.raw[tid]) + kEpsF;
        const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
        l += s.sq[tid] / (2.f * sv) + n_dims * logf(sv) / 2.f;
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

// K6 (V = kBase) and K8's variant V: out[row] = the negative log-posterior,
// one evaluation (ev = 0).
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

// K5: n_steps MH steps for the tile's rows, z, x, y, v and logp held in
// shared memory for the whole window.
__global__ void __launch_bounds__(kThreads) inkernel_mh_steps_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const EvalSmem s = carve_eval(smem, p);
  const int zd = p.z_dim, vd = p.v_dim;
  float* zt = smem + eval_smem_floats(p);  // current state
  float* zp = zt + kTileRows * zd;          // proposal
  float* vt = zp + kTileRows * zd;
  float* xt = vt + kTileRows * vd;
  float* yt = xt + kTileRows;
  float* lp_prop = yt + kTileRows;
  float* logp = lp_prop + kTileRows;
  int* accepted = reinterpret_cast<int*>(logp + kTileRows);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTileRows;
  const int n_valid = min(kTileRows, p.n_rows - row0);
  const int blk = row0 / p.block_rows;
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const float q_sd = *p.q_sd;

  for (int idx = tid; idx < kTileRows * zd; idx += blockDim.x) {
    const int r = idx / zd;
    zt[idx] = r < n_valid ? p.z[(size_t)row0 * zd + idx] : 0.f;
    zp[idx] = 0.f;
  }
  for (int idx = tid; idx < kTileRows * vd; idx += blockDim.x)
    vt[idx] = idx / vd < n_valid ? p.v[(size_t)row0 * vd + idx] : 0.f;
  if (tid < kTileRows) {
    xt[tid] = tid < n_valid ? p.x[row0 + tid] : 0.f;
    yt[tid] = tid < n_valid ? p.y[row0 + tid] : 0.f;
    logp[tid] = 0.f;
  }

  const int quads = (((zd + 1) >> 1) + 1) >> 1;  // Philox calls per row's proposal
  for (int step = 0; step < p.n_steps; ++step) {
    __syncthreads();
    for (int idx = tid; idx < kTileRows * quads; idx += blockDim.x) {
      const int r = idx / quads, q = idx - r * quads;
      if (r >= n_valid) continue;
      normal_quad(make_uint4((uint32_t)(row0 + r), (uint32_t)q, (uint32_t)step, kTagProposal),
                  key, 1, zd, [&](int, int j, float e) {
                    zp[r * zd + j] = __fadd_rn(zt[r * zd + j], __fmul_rn(q_sd, e));
                  });
    }
    tile_neg_logp<kBase>(p, s, zp, xt, yt, vt, row0, n_valid, blk, 2u * step, key);
    if (tid < kTileRows) lp_prop[tid] = -s.loss[tid];
    tile_neg_logp<kBase>(p, s, zt, xt, yt, vt, row0, n_valid, blk, 2u * step + 1u, key);
    if (tid < kTileRows) {  // warp 0, all 32 lanes
      const float lp_cur = -s.loss[tid];
      const uint4 w = philox4x32_10(
          make_uint4((uint32_t)(row0 + tid), 0u, (uint32_t)step, kTagAccept), key);
      const float u = fmaxf(uniform24(w.x), 1e-30f);
      const bool acc = tid < n_valid && logf(u) < (lp_prop[tid] - lp_cur);
      logp[tid] = acc ? lp_prop[tid] : lp_cur;
      accepted[tid] = acc;
      const int cnt = __popc(__ballot_sync(0xffffffffu, acc));
      if (tid == 0 && cnt) atomicAdd(p.counts + step, (float)cnt);
    }
    __syncthreads();
    for (int idx = tid; idx < kTileRows * zd; idx += blockDim.x)
      if (accepted[idx / zd]) zt[idx] = zp[idx];
  }
  __syncthreads();
  for (int idx = tid; idx < n_valid * zd; idx += blockDim.x)
    p.z_out[(size_t)row0 * zd + idx] = zt[idx];
  if (tid < n_valid) p.out[row0 + tid] = logp[tid];
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

    // The chain's likelihood term and its output cotangent.  The squared
    // error is summed as K6 sums it (lane-strided, then a xor butterfly).
    const int d_mu = ch == 0 ? p.v_dim : 1;
    const int out_last = c.dims[n_layers];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      float acc = 0.f;
      if (r < n_valid) {
        const int row = row0 + r;
        for (int col = lane; col < d_mu; col += 32) {
          const float t = ch == 0 ? p.v[(size_t)row * p.v_dim + col] : (ch == 1 ? p.x[row] : p.y[row]);
          const float d = t - cot[r * ws + col];
          acc = fmaf(d, d, acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sq[r] = acc;
    }
    __syncthreads();
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
    const bool binary_head = ch == 1 && p.binary;
    for (int idx = tid; idx < kTileRows * out_last; idx += blockDim.x) {
      const int r = idx / out_last, col = idx - r * out_last;
      float cval = 0.f;
      if (r < n_valid) {
        if (binary_head) {
          cval = col == 0 ? c_var[r] : 0.f;
        } else if (col < d_mu) {
          const int row = row0 + r;
          const float t = ch == 0 ? p.v[(size_t)row * p.v_dim + col] : (ch == 1 ? p.x[row] : p.y[row]);
          cval = -(t - cot[r * ws + col]) / s_row[r];
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
  return launch(inkernel_logp_kernel<kBase>, p, sizeof(float) * eval_smem_floats(p), stream);
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
  const size_t smem = sizeof(float) * (eval_smem_floats(p) +
                                       kTileRows * (2 * (size_t)z_dim + v_dim + 5));
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (n_steps > 0) {
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(float) * n_steps,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return launch(inkernel_mh_steps_kernel, p, smem, stream);
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
    case kErrShape: return "a layer width is < 1, a chain's input or output width is wrong, n_steps < 0, or an unknown probe variant";
    case kErrBlockRows: return "block_rows must be a positive multiple of the kernel's 32-row tile";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
