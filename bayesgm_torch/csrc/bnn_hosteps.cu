// Flipout-BNN CausalBGM negative log-posterior with host-provided weight noise.
//
// Replaces the TPU kernel bayesgm_tpu/ops/_pk_bnn_hosteps.py::
// make_fused_causal_logp_bnn_hosteps (both its unpaired and paired modes).
// The plain PyTorch version of the same function is
// bayesgm_torch/ops/_pk_bnn_hosteps.py::logp_plain; the two agree to f32
// summation order, and their sign words agree bit for bit.
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
// What bounds it on an H100: f32 FMA work, no tensor cores.  One paired
// evaluation at the flagship width (g [10, 64x5, 201], h/f [., 64, 32, 8, 2])
// is 139,392 flops per row over ~1.4 KB of row data, about 99 flop/byte, so
// the weights' re-reads and the FMA pipes, not HBM, set its time.
//
// What the design does about it: one block of 8 warps takes a tile of 32
// rows that all use one eps set (the grid is split at n_half, so a tile never
// straddles the two sets).  Each layer's loc and P[set] (at most 64 x 201,
// about 103 KB together) are staged into shared memory once per tile; the
// weights of all layers (~279 KB) do not fit at once.  The activations and
// the sign words stay in shared memory for the whole tile.  Each warp owns
// 4 rows and walks the output columns with its 32 lanes, so every staged
// weight read feeds 8 FMAs and the activation reads are broadcasts.  The
// last layer of each chain is never written out: its columns fold straight
// into the per-row squared error (reduced across the warp) and the variance
// head.  This is the simple, correct first form; register tiling, wider row
// tiles and pipelined staging are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 20;  // per chain (above 16, signs use word group 1)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
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
};

struct Params {
  Chain chain[3];
  const float* z;
  const float* x;
  const float* y;
  const float* v;
  const int* seed;
  float* out;
  int n_rows, n_half, z_dim, v_dim, d0, d1, d2;
  int binary;
  int fixed_mask;  // bit 0: sigma_v fixed, bit 1: sigma_x, bit 2: sigma_y
  float sigma_v, sigma_x, sigma_y;
  int blocks_half0;
  int words_stride;  // max over chains of max_w
  int act_stride;    // max over chains of a layer's input width
  int w_max;         // max over layers of in * out
  int b_max;         // max over layers of out
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

// words[r * stride + col] for the tile's rows (0 past the valid rows).
__device__ void fill_words(uint32_t* words, int stride, int row0, int n_valid,
                           int cols, int chain, int group, uint2 key) {
  const int q = (cols + 3) / 4;
  for (int idx = threadIdx.x; idx < kTileRows * q; idx += blockDim.x) {
    const int r = idx / q, c4 = idx - r * q;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      w = philox4x32_10(make_uint4((uint32_t)(row0 + r), (uint32_t)c4,
                                   (uint32_t)chain, (uint32_t)group), key);
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

__global__ void __launch_bounds__(kThreads)
bnn_hosteps_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* act = smem + kTileRows * p.words_stride;
  float* sgn = act + kTileRows * p.act_stride;
  float* nxt = sgn + kTileRows * p.act_stride;
  float* wl = nxt + kTileRows * p.act_stride;
  float* wp = wl + p.w_max;
  float* wb = wp + p.w_max;
  float* loss = wb + p.b_max;
  float* sq = loss + kTileRows;
  float* mu0 = sq + kTileRows;
  float* raw = mu0 + kTileRows;

  int set, row0, row_end;
  if ((int)blockIdx.x < p.blocks_half0) {
    set = 0;
    row0 = blockIdx.x * kTileRows;
    row_end = p.n_half;
  } else {
    set = 1;
    row0 = p.n_half + (blockIdx.x - p.blocks_half0) * kTileRows;
    row_end = p.n_rows;
  }
  const int n_valid = min(kTileRows, row_end - row0);
  const uint2 key = make_uint2((uint32_t)p.seed[0], (uint32_t)p.seed[1]);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int as = p.act_stride, ws = p.words_stride;
  if (tid < kTileRows) loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    // Chain input (after the frozen-BN affine): g takes z, h takes (z0, z2),
    // f takes (z0, z1, x).  Rows past the tile's end read as 0.
    const int in0 = c.dims[0];
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      float val = 0.f;
      if (r < n_valid) {
        const int row = row0 + r;
        if (ch == 0) {
          val = p.z[row * p.z_dim + k];
        } else if (ch == 1) {
          const int col = k < p.d0 ? k : p.d0 + p.d1 + (k - p.d0);
          val = p.z[row * p.z_dim + col];
        } else {
          val = k < p.d0 + p.d1 ? p.z[row * p.z_dim + k] : p.x[row];
        }
        val = val * c.gamma[k] + c.beta[k];
      }
      act[r * as + k] = val;
    }

    int group = -1;
    for (int i = 0; i < c.n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == c.n_layers - 1;
      if (((2 * i) >> 5) != group) {
        group = (2 * i) >> 5;
        fill_words(words, ws, row0, n_valid, c.max_w, ch, group, key);
        __syncthreads();
      }
      const int bit_in = (2 * i) & 31, bit_out = (2 * i + 1) & 31;

      // Stage this layer's weights and the sign-flipped activations.
      for (int idx = tid; idx < kTileRows * in; idx += blockDim.x) {
        const int r = idx / in, k = idx - r * in;
        const float h = act[r * as + k];
        sgn[r * as + k] = ((words[r * ws + k] >> bit_in) & 1u) ? -h : h;
      }
      const float* loc = c.loc[i];
      const float* P = c.P[i] + (size_t)set * in * out;
      for (int idx = tid; idx < in * out; idx += blockDim.x) {
        wl[idx] = loc[idx];
        wp[idx] = P[idx];
      }
      for (int idx = tid; idx < out; idx += blockDim.x) wb[idx] = c.b[i][idx];
      __syncthreads();

      const int d_mu = ch == 0 ? p.v_dim : 1;
      float sq_acc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) sq_acc[j] = 0.f;
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
          const float pre = (am[j] + bc) + pert;
          if (!last) {
            nxt[r * as + col] = pre > 0.f ? pre : kLeakySlope * pre;
          } else if (r < n_valid) {
            const int row = row0 + r;
            if (col < d_mu) {
              const float t = ch == 0 ? p.v[row * p.v_dim + col]
                                      : (ch == 1 ? p.x[row] : p.y[row]);
              const float d = t - pre;
              sq_acc[j] = fmaf(d, d, sq_acc[j]);
            }
            if (col == 0) mu0[r] = pre;
            if (col == d_mu) raw[r] = pre;
          }
        }
      }
      if (last) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          float s = sq_acc[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) sq[warp * kRowsPerWarp + j] = s;
        }
      }
      __syncthreads();
      float* t = act;
      act = nxt;
      nxt = t;
    }

    // Fold this chain's likelihood term into the row's loss.
    if (tid < n_valid) {
      const int row = row0 + tid;
      float l = loss[tid];
      if (ch == 1 && p.binary) {
        const float lx = mu0[tid];
        l += fmaxf(lx, 0.f) - lx * p.x[row] + log1pf(expf(-fabsf(lx)));
      } else {
        const bool fixed = (p.fixed_mask >> ch) & 1;
        const float sigma = ch == 0 ? p.sigma_v : (ch == 1 ? p.sigma_x : p.sigma_y);
        const float s = fixed ? sigma * sigma : softplus(raw[tid]) + kEpsF;
        const float n_dims = ch == 0 ? (float)p.v_dim : 1.f;
        l += sq[tid] / (2.f * s) + n_dims * logf(s) / 2.f;
      }
      loss[tid] = l;
    }
  }

  if (tid < n_valid) {
    const int row = row0 + tid;
    float zz = 0.f;
    for (int k = 0; k < p.z_dim; ++k) {
      const float zk = p.z[row * p.z_dim + k];
      zz = fmaf(zk, zk, zz);
    }
    p.out[row] = loss[tid] + zz / 2.f;
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
  Params p = {};
  int di = 0, pi = 0;
  p.words_stride = p.act_stride = p.w_max = p.b_max = 1;
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
    for (int i = 0; i < c.n_layers; ++i) {
      c.loc[i] = static_cast<const float*>(ptrs[pi++]);
      c.b[i] = static_cast<const float*>(ptrs[pi++]);
      c.P[i] = static_cast<const float*>(ptrs[pi++]);
      const int in = c.dims[i], o = c.dims[i + 1];
      if (in > p.act_stride) p.act_stride = in;
      if (in * o > p.w_max) p.w_max = in * o;
      if (o > p.b_max) p.b_max = o;
    }
    if (c.max_w > p.words_stride) p.words_stride = c.max_w;
  }
  const int d_out[3] = {v_dim + 1, 2, 2};
  for (int ch = 0; ch < 3; ++ch)
    if (p.chain[ch].dims[p.chain[ch].n_layers] < d_out[ch]) return kErrShape;
  p.z = z;
  p.x = x;
  p.y = y;
  p.v = v;
  p.seed = seed;
  p.out = out;
  p.n_rows = n_rows;
  p.n_half = n_half;
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

  const size_t smem = sizeof(float) * ((size_t)kTileRows * p.words_stride +
                                       3 * (size_t)kTileRows * p.act_stride +
                                       2 * (size_t)p.w_max + p.b_max + 4 * kTileRows);
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (n_rows <= 0) return 0;
  p.blocks_half0 = (n_half + kTileRows - 1) / kTileRows;
  const int blocks = p.blocks_half0 + (n_rows - n_half + kTileRows - 1) / kTileRows;
  cudaError_t err = cudaFuncSetAttribute(
      bnn_hosteps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bnn_hosteps_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
    case kErrSmem: return "the widest layer does not fit in 227 KB of shared memory";
    case kErrShape: return "a layer width is < 1 or a chain's output is too narrow";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
