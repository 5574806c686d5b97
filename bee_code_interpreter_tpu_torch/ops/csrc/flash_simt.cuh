// Flash attention on the CUDA cores: the forward (K1), dK/dV (K3) and dQ
// (K4) for what the tensor-core instances of flash_fwd.cu, flash_bwd_dkdv.cu
// and flash_bwd_dq.cu do not take. Each of those sources includes this
// header and exports one C entry point of its own kernel from it, so the
// launches count on the kernel they stand in for.
//
// What it takes: f32 inputs at every head dim 1 <= D <= 256. JAX's kernels
// keep the inputs' dtype in both products
// (bee_code_interpreter_tpu/ops/flash_attention.py:88-91, :109-112), so f32
// is computed in f32 here, FMA by FMA: neither rounded to bf16 nor single-pass
// TF32 (which keeps about three digits); P and dS stay f32 too. The math is
// that of the tensor-core kernels:
// the online softmax in base 2 with the scale folded in, lse = m + log(max(l,
// 1e-30)), P = exp(S * scale - lse) forced to 0 on invalid pairs (:271-288),
// dS = P (dP - delta) scale; rows >= Lq and keys >= Lk are masked, not padded.
//
// Bound on this card: operations, as for the tensor-core kernels, but here at
// the CUDA cores' rate (67 TFLOP/s f32 on an H100 SXM) and below it: every
// operand is read from shared memory once per multiply-add (a thread owns a
// row's 8 keys or a key's D/4 columns, with no register tile), so the kernels
// are bound by shared-memory bandwidth first. A tile is DP + 1 floats a row
// (DP, the head dim rounded up to 32, 64, 128 or 256), so the rows of a warp
// fall on distinct banks. The plain design is the one that is right at every
// head dim in one template; register tiles are the next step (PERF.md).
//
// - K1: a block owns 64 query rows of one (batch, head), 256 threads, four a
//   row; key tiles of 32 keys from the first visible to the last; each
//   thread holds 8 scores of its row, then DP/4 output columns (j + 4n);
// - K4: the same blocks and layout, with dO beside Q and dQ accumulating
//   dS K;
// - K3: a block owns 32 keys of one (batch, KV head), 128 threads, and walks
//   every query head of the group and every 64-row query tile that can see
//   the keys; a thread computes 16 scores and dP of one query row, then
//   holds DP/4 columns of one key's dK and dV.
// Two calls give the same bits (no atomics, a fixed order of sums).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_simt {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 32;  // keys per tile
constexpr int FWD_THREADS = 256;
constexpr int DKDV_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// rows [0, rows) of a [*, D] tile of one head into shared memory as
// [rows][DP + 1], zero past n_valid rows and past column D
template <int DP, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int rows, int n_valid, int D) {
  for (int i = threadIdx.x; i < rows * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    dst[r * (DP + 1) + c] = r < n_valid && c < D ? src[(size_t)r * D + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int key, int Lq, int Lk, int causal,
                                        int window) {
  return row < Lq && key < Lk && (!causal || key <= row) &&
         (window <= 0 || row - key < window);
}

// shared memory of each kernel, in bytes
template <int DP>
constexpr int fwd_smem() {
  return ((BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1)) * 4;
}
template <int DP>
constexpr int dq_smem() {
  return ((2 * BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1)) * 4;
}
template <int DP>
constexpr int dkdv_smem() {
  return ((2 * BQ + 2 * BK) * (DP + 1) + 2 * BQ * (BK + 1) + 2 * BQ) * 4;
}

// grid (query tiles, B * H)
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int H, int KVH, int Lq, int Lk, int D,
    int causal, int window, float sm_scale) {
  constexpr int S = DP + 1, NC = DP / 4;
  extern __shared__ float smem[];
  float* qs = smem;          // [BQ][S]
  float* ks = qs + BQ * S;   // [BK][S]
  float* vs = ks + BK * S;   // [BK][S]
  float* ps = vs + BK * S;   // [BQ][BK + 1]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x >> 2, j = threadIdx.x & 3, qi = q0 + row;
  const float* kg = k + bkv * Lk * D;
  const float* vg = v + bkv * Lk * D;
  load_tile<DP, FWD_THREADS>(qs, q + ((size_t)bh * Lq + q0) * D, BQ, Lq - q0, D);
  const int q_last = min(q0 + BQ, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float c = sm_scale * LOG2E;
  float m = -INFINITY, l = 0.f, acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;
  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // every thread is done with the last tile
    load_tile<DP, FWD_THREADS>(ks, kg + (size_t)k0 * D, BK, Lk - k0, D);
    load_tile<DP, FWD_THREADS>(vs, vg + (size_t)k0 * D, BK, Lk - k0, D);
    __syncthreads();
    float s[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float x = qs[row * S + d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) s[i] = fmaf(x, ks[(j + 4 * i) * S + d], s[i]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      s[i] = visible(qi, k0 + j + 4 * i, Lq, Lk, causal, window) ? s[i] * c : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m, mx);
    // a row that has seen no visible key yet keeps m = -inf and adds nothing
    const float alpha = m_new == -INFINITY ? 1.f : exp2f(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = m_new == -INFINITY ? 0.f : exp2f(s[i] - m_new);
      ps[row * (BK + 1) + j + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the row's four lanes wrote its P
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[n] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = ps[row * (BK + 1) + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[n] = fmaf(p, vs[kk * S + j + 4 * n], acc[n]);
    }
  }
  if (qi < Lq) {
    float* o = out + ((size_t)bh * Lq + qi) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (j + 4 * n < D) o[j + 4 * n] = acc[n] * inv;
    }
    if (j == 0) lse[(size_t)bh * Lq + qi] = m / LOG2E + logf(fmaxf(l, 1e-30f));
  }
}

// grid (query tiles, B * H)
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int KVH, int Lq, int Lk,
    int D, int causal, int window, float sm_scale) {
  constexpr int S = DP + 1, NC = DP / 4;
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][S]
  float* dos = qs + BQ * S;   // [BQ][S]
  float* ks = dos + BQ * S;   // [BK][S]
  float* vs = ks + BK * S;    // [BK][S]
  float* dss = vs + BK * S;   // [BQ][BK + 1]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KVH + h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int row = threadIdx.x >> 2, j = threadIdx.x & 3, qi = q0 + row;
  const float* kg = k + bkv * Lk * D;
  const float* vg = v + bkv * Lk * D;
  load_tile<DP, FWD_THREADS>(qs, q + ((size_t)bh * Lq + q0) * D, BQ, Lq - q0, D);
  load_tile<DP, FWD_THREADS>(dos, dout + ((size_t)bh * Lq + q0) * D, BQ, Lq - q0, D);
  const float lse2 = qi < Lq ? lse[(size_t)bh * Lq + qi] * LOG2E : 0.f;
  const float dlt = qi < Lq ? delta[(size_t)bh * Lq + qi] : 0.f;
  const int q_last = min(q0 + BQ, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float c = sm_scale * LOG2E;
  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;
  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    load_tile<DP, FWD_THREADS>(ks, kg + (size_t)k0 * D, BK, Lk - k0, D);
    load_tile<DP, FWD_THREADS>(vs, vg + (size_t)k0 * D, BK, Lk - k0, D);
    __syncthreads();
    float s[BK / 4], dp[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float x = qs[row * S + d], g = dos[row * S + d];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        s[i] = fmaf(x, ks[(j + 4 * i) * S + d], s[i]);
        dp[i] = fmaf(g, vs[(j + 4 * i) * S + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = visible(qi, k0 + j + 4 * i, Lq, Lk, causal, window)
                          ? exp2f(s[i] * c - lse2) : 0.f;
      dss[row * (BK + 1) + j + 4 * i] = p * (dp[i] - dlt) * sm_scale;
    }
    __syncwarp();
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dss[row * (BK + 1) + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[n] = fmaf(ds, ks[kk * S + j + 4 * n], acc[n]);
    }
  }
  if (qi < Lq) {
    float* o = dq + ((size_t)bh * Lq + qi) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (j + 4 * n < D) o[j + 4 * n] = acc[n];
    }
  }
}

// grid (key tiles, B * KVH)
template <int DP>
__global__ void __launch_bounds__(DKDV_THREADS) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H,
    int KVH, int Lq, int Lk, int D, int causal, int window, float sm_scale) {
  constexpr int S = DP + 1, NC = DP / 4, KS = BK / 2;
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][S]
  float* vs = ks + BK * S;      // [BK][S]
  float* qs = vs + BK * S;      // [BQ][S]
  float* dos = qs + BQ * S;     // [BQ][S]
  float* ps = dos + BQ * S;     // [BQ][BK + 1]
  float* dss = ps + BQ * (BK + 1);  // [BQ][BK + 1]
  float* lse2s = dss + BQ * (BK + 1);  // [BQ]
  float* dlts = lse2s + BQ;     // [BQ]
  const int bkv = blockIdx.y, b = bkv / KVH, g = bkv % KVH, rep = H / KVH;
  const int k0 = blockIdx.x * BK;
  const int t = threadIdx.x;
  // scores: query row sr of the tile, keys sj + 2 i; accumulation: key ak,
  // columns aj + 4 n
  const int sr = t >> 1, sj = t & 1, ak = t >> 2, aj = t & 3;
  load_tile<DP, DKDV_THREADS>(ks, k + ((size_t)bkv * Lk + k0) * D, BK, Lk - k0, D);
  load_tile<DP, DKDV_THREADS>(vs, v + ((size_t)bkv * Lk + k0) * D, BK, Lk - k0, D);
  const int k_last = min(k0 + BK, Lk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Lq, k_last + window) : Lq;
  const float c = sm_scale * LOG2E;
  float adk[NC], adv[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) adk[n] = adv[n] = 0.f;
  for (int r = 0; r < rep; ++r) {
    const size_t bh = (size_t)b * H + g * rep + r;
    for (int q0 = q_lo / BQ * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // every thread is done with the last query tile
      load_tile<DP, DKDV_THREADS>(qs, q + (bh * Lq + q0) * D, BQ, Lq - q0, D);
      load_tile<DP, DKDV_THREADS>(dos, dout + (bh * Lq + q0) * D, BQ, Lq - q0, D);
      for (int i = t; i < BQ; i += DKDV_THREADS) {
        const bool in = q0 + i < Lq;
        lse2s[i] = in ? lse[bh * Lq + q0 + i] * LOG2E : 0.f;
        dlts[i] = in ? delta[bh * Lq + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[KS], dp[KS];
#pragma unroll
      for (int i = 0; i < KS; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float x = qs[sr * S + d], gd = dos[sr * S + d];
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          s[i] = fmaf(x, ks[(sj + 2 * i) * S + d], s[i]);
          dp[i] = fmaf(gd, vs[(sj + 2 * i) * S + d], dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int key = sj + 2 * i;
        const float p = visible(q0 + sr, k0 + key, Lq, Lk, causal, window)
                            ? exp2f(s[i] * c - lse2s[sr]) : 0.f;
        ps[sr * (BK + 1) + key] = p;
        dss[sr * (BK + 1) + key] = p * (dp[i] - dlts[sr]) * sm_scale;
      }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[i * (BK + 1) + ak], ds = dss[i * (BK + 1) + ak];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          adv[n] = fmaf(p, dos[i * S + aj + 4 * n], adv[n]);
          adk[n] = fmaf(ds, qs[i * S + aj + 4 * n], adk[n]);
        }
      }
    }
  }
  if (k0 + ak < Lk) {
    const size_t at = ((size_t)bkv * Lk + k0 + ak) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      if (aj + 4 * n < D) {
        dk[at + aj + 4 * n] = adk[n];
        dv[at + aj + 4 * n] = adv[n];
      }
    }
  }
}

// The head dim rounded up to a tile width: 32, 64, 128 or 256 (0 above 256)
inline int padded_dim(int D) {
  return D < 1 ? 0 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int smem) {
  // above the 48 KB default: opt in (cheap to repeat)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int H, int KVH, int Lq, int Lk, int D, int causal,
                       int window, float sm_scale, cudaStream_t stream) {
  auto kernel = fwd_kernel<DP>;
  cudaError_t err = prepare(kernel, fwd_smem<DP>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Lq + BQ - 1) / BQ, B * H), FWD_THREADS, fwd_smem<DP>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, KVH, Lq, Lk, D, causal, window,
      sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int KVH,
                      int Lq, int Lk, int D, int causal, int window, float sm_scale,
                      cudaStream_t stream) {
  auto kernel = dq_kernel<DP>;
  cudaError_t err = prepare(kernel, dq_smem<DP>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Lq + BQ - 1) / BQ, B * H), FWD_THREADS, dq_smem<DP>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, KVH, Lq, Lk, D, causal,
      window, sm_scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B,
                        int H, int KVH, int Lq, int Lk, int D, int causal, int window,
                        float sm_scale, cudaStream_t stream) {
  auto kernel = dkdv_kernel<DP>;
  cudaError_t err = prepare(kernel, dkdv_smem<DP>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Lk + BK - 1) / BK, B * KVH), DKDV_THREADS, dkdv_smem<DP>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), H, KVH,
      Lq, Lk, D, causal, window, sm_scale);
  return cudaGetLastError();
}

// One instance per padded head dim; cudaErrorInvalidValue for a head dim
// outside 1..256.
#define BCI_FLASH_SIMT_DISPATCH(LAUNCH, ...)      \
  do {                                           \
    switch (padded_dim(D)) {                     \
      case 32: return LAUNCH<32>(__VA_ARGS__);   \
      case 64: return LAUNCH<64>(__VA_ARGS__);   \
      case 128: return LAUNCH<128>(__VA_ARGS__); \
      case 256: return LAUNCH<256>(__VA_ARGS__); \
      default: return cudaErrorInvalidValue;     \
    }                                            \
  } while (0)

inline cudaError_t fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int H, int KVH, int Lq, int Lk, int D, int causal,
                       int window, float sm_scale, cudaStream_t stream) {
  BCI_FLASH_SIMT_DISPATCH(launch_fwd, q, k, v, out, lse, B, H, KVH, Lq, Lk, D, causal,
                          window, sm_scale, stream);
}

inline cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq_out, int B, int H,
                      int KVH, int Lq, int Lk, int D, int causal, int window,
                      float sm_scale, cudaStream_t stream) {
  BCI_FLASH_SIMT_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq_out, B, H, KVH, Lq, Lk,
                          D, causal, window, sm_scale, stream);
}

inline cudaError_t dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B,
                        int H, int KVH, int Lq, int Lk, int D, int causal, int window,
                        float sm_scale, cudaStream_t stream) {
  BCI_FLASH_SIMT_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Lq,
                          Lk, D, causal, window, sm_scale, stream);
}

#undef BCI_FLASH_SIMT_DISPATCH

}  // namespace flash_simt
