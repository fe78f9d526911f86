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
// the fit batch of 32 rows K3 is one block on one SM of 132: the serial walk
// over the staged layers and the launch set its time, not the arithmetic.
//
// What the design does about it: the tile of K1/K2 (csrc/bnn_hosteps.cu)
// without the flipout terms.  One block of 8 warps takes 32 rows; each warp
// owns 4 rows and walks the output columns with its 32 lanes, so every staged
// weight read feeds 4 FMAs and the activation reads are warp broadcasts.
// Each layer's w and b are staged in shared memory once per tile: all the
// plain weights of a model (~142 KB at the benchmark width) would fit, but
// not beside K3's tape.  K4 never writes a chain's last layer out: its
// columns fold straight into the row's squared error (reduced across the
// warp) and the variance head.  K3 keeps every hidden pre-activation of the
// chain and the last layer's whole output in shared memory, holds the
// cotangent in two ping-pong buffers (the second aliases the forward's
// activations), and stages each layer's w again for the backward with an odd
// row stride (out | 1), so the 32 lanes walking the input columns hit 32
// banks.  K3 computes the value with K4's loops in K4's order, so the two
// agree bit for bit.  At the benchmark width K4 takes ~69 KB of shared memory
// per block and K3 ~146 KB; a shape that does not fit returns kErrSmem.
// Register tiling, more rows per block, wgmma and TMA staging are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 20;  // per chain
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

// K4.
__global__ void __launch_bounds__(kThreads)
plain_logp_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int as = p.act_stride;
  float* act = smem;
  float* nxt = act + kTileRows * as;
  float* wl = nxt + kTileRows * as;
  float* wb = wl + p.w_max;
  float* loss = wb + p.b_max;
  float* sq = loss + kTileRows;
  float* mu0 = sq + kTileRows;
  float* raw = mu0 + kTileRows;

  const int row0 = blockIdx.x * kTileRows;
  const int n_valid = min(kTileRows, p.n_rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < kTileRows) loss[tid] = 0.f;

  for (int ch = 0; ch < 3; ++ch) {
    const Chain& c = p.chain[ch];
    // Chain input; rows past the tile's end read as 0.
    const int in0 = c.dims[0];
    for (int idx = tid; idx < kTileRows * in0; idx += blockDim.x) {
      const int r = idx / in0, k = idx - r * in0;
      act[r * as + k] = r < n_valid ? chain_input(p, ch, row0 + r, k) : 0.f;
    }
    const int d_mu = ch == 0 ? p.v_dim : 1;
    for (int i = 0; i < c.n_layers; ++i) {
      const int in = c.dims[i], out = c.dims[i + 1];
      const bool last = i == c.n_layers - 1;
      const float* w = c.w[i];
      for (int idx = tid; idx < in * out; idx += blockDim.x) wl[idx] = w[idx];
      for (int idx = tid; idx < out; idx += blockDim.x) wb[idx] = c.b[i][idx];
      __syncthreads();

      float sq_acc[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) sq_acc[j] = 0.f;
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
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          const float pre = am[j] + bc;
          if (!last) {
            nxt[r * as + col] = leaky(pre);
          } else if (r < n_valid) {
            if (col < d_mu) {
              const float d = target(p, ch, row0 + r, col) - pre;
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
    if (tid < n_valid) loss[tid] += head_nll(p, ch, row0 + tid, sq[tid], mu0[tid], raw[tid]);
  }
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
    // error is summed as K4 sums it (lane-strided, then a xor butterfly).
    const int d_mu = ch == 0 ? p.v_dim : 1;
    const int out_last = c.dims[n_layers];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      float acc = 0.f;
      if (r < n_valid) {
        for (int col = lane; col < d_mu; col += 32) {
          const float d = target(p, ch, row0 + r, col) - cot[r * ws + col];
          acc = fmaf(d, d, acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sq[r] = acc;
    }
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
  return 0;
}

int launch(void (*kernel)(const Params), const Params& p, size_t smem, void* stream) {
  if (smem > (size_t)kMaxSmemBytes) return kErrSmem;
  if (p.n_rows <= 0) return 0;
  const int blocks = (p.n_rows + kTileRows - 1) / kTileRows;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
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
  const size_t smem = sizeof(float) * (2 * (size_t)kTileRows * p.act_stride +
                                       (size_t)p.w_max + p.b_max + 4 * kTileRows);
  return launch(plain_logp_kernel, p, smem, stream);
}

// K3: out (n_rows,) = negative log-posterior and grad (n_rows, z_dim) = its
// z-gradient.  Arguments as for plain_logp.
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
  const size_t smem = sizeof(float) * ((size_t)kTileRows * (p.pre_stride + 2 * (size_t)p.width) +
                                       (size_t)p.wt_max + p.b_max +
                                       (size_t)kTileRows * (z_dim + 4));
  return launch(plain_grad_kernel, p, smem, stream);
}

const char* plain_error_string(int code) {
  switch (code) {
    case kErrTooManyLayers: return "a chain has 0 or more than 20 layers";
    case kErrSmem: return "the tile's buffers for these widths do not fit in 227 KB of shared memory";
    case kErrShape: return "a layer width is < 1, or a chain's input or output width is wrong";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
