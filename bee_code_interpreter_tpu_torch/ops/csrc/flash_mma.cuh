// Flash attention at head dim 256 in bf16 on the tensor cores: the forward
// (K1), dK/dV (K3) and dQ (K4) for Gemma-2B's widths (8 heads over one KV
// head of 256), which the TMA/wgmma instances of flash_fwd.cu,
// flash_bwd_dkdv.cu and flash_bwd_dq.cu do not take: at 256 columns their
// 128-row tiles and two-stage rings would need 384 KB of shared memory, and
// K3's dK and dV accumulators of a 64-row key tile would be 128 KB of
// registers. Each of those sources includes this header and exports its own
// kernel from it (bci_flash_*_bf16_d256). It reads a head dim D between 128
// and 256 that is a multiple of 8 in place (rows of D columns, the tile's
// columns past D zeros, nothing stored past D); the wrapper zero-pads any
// other to 256 (exact, the scale stays the true D ** -0.5).
//
// The math is the wgmma instances': the online softmax in base 2 with the
// scale folded in, lse = m + log(max(l, 1e-30)), P = exp(S scale - lse)
// forced to 0 on invalid pairs, dS = P (dP - delta) scale; P and dS are
// rounded to bf16 as the A operand of the next product, every sum is f32.
// Rows >= Lq and keys >= Lk are masked, never read as data.
//
// Bound on this card: operations (4 L^2 D flops a head forward at 256
// columns, well above the ~295 operations per byte where the tensor cores
// become the limit). The design is the warp-level one of the paged decode
// kernel's tensor-core path (mma.sync m16n8k16, fragments by ldmatrix)
// rather than wgmma, so it fits the smaller tiles this width needs:
// - a warp owns 16 rows (queries in K1/K4, keys in K3); four warps a block;
// - tiles sit in shared memory as [rows][256 + 8] bf16: the 16-byte row
//   skew puts the 8 rows an ldmatrix reads on distinct banks (no swizzle);
//   they are loaded with 16-byte vector loads (the wrapper checks the
//   operands are dense and 16-byte aligned), synchronously, and two blocks
//   fit an SM (~101 KB each), so one block's loads overlap the other's
//   products;
// - K1: 64 query rows a block over key tiles of 64; S (16 x 64 a warp) and
//   the output (16 x 256: 128 f32 registers a thread) stay in registers, P
//   goes from the S accumulator straight into the A operand of P V, V read
//   transposed by ldmatrix.trans;
// - K4: 64 query rows a block over key tiles of 32: S and dP in registers,
//   dS the A operand of dQ += dS K;
// - K3: 64 keys a block; the 256 output columns of dK and dV split over two
//   blocks (gridDim.z), each recomputing S^T = K Q^T and dP^T = V dO^T over
//   the full 256 (twice the work of those two products, half the
//   accumulator registers: 128 a thread), over query tiles of 32 of every
//   head of the group. (Four column blocks of two warps, a grid four times
//   as wide, measured slower on an NVIDIA H100 80GB HBM3 at 700 W: 1.00
//   against 0.89 ms at B=1 H=8 KVH=1 L=1024 causal.)
// What is left: no cp.async/TMA pipeline inside a block, so a block waits for
// each tile's loads; and under causal masking K3's first key tile walks
// every query tile of every head of the group, a chain that sets its time
// (splitting the group's heads over blocks needs a second pass to sum them);
// both are the next steps (PERF.md).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_mma {

using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma_m16n8k16;
using hopper::pack_bf16;

constexpr int D = 256;
constexpr int ROW = D + 8;        // bf16 elements a shared-memory row holds
constexpr int CHUNKS = D / 8;     // 16-byte pieces of a row
constexpr int THREADS = 128;      // four warps (K1, K4)
constexpr int FWD_Q = 64, FWD_K = 64;    // K1: query rows, keys a tile
constexpr int DQ_Q = 64, DQ_K = 32;      // K4
// K3: four warps of 16 keys a block, each block half of the output columns,
// over query tiles of 32
constexpr int DKDV_THREADS = THREADS, DKDV_K = 64, DKDV_Q = 32;
constexpr int DKDV_SPLIT = 2, DKDV_COLS = D / DKDV_SPLIT;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int tile_bytes(int rows) { return rows * ROW * 2; }
constexpr int FWD_SMEM = tile_bytes(FWD_Q) + 2 * tile_bytes(FWD_K);
constexpr int DQ_SMEM = 2 * tile_bytes(DQ_Q) + 2 * tile_bytes(DQ_K);
constexpr int DKDV_SMEM = 2 * tile_bytes(DKDV_K) + 2 * tile_bytes(DKDV_Q) + 2 * DKDV_Q * 4;

// rows [0, rows) of a [*, cols] bf16 tensor (cols a multiple of 8, at most
// 256) into a [rows][ROW] tile, zero past n_valid rows and past column cols;
// NT threads share the copy
template <int NT = THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int n_valid, int cols) {
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NT) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid && c * 8 < cols) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)r * cols + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * ROW + c * 8) = v;
  }
}

// the A operand (16 x 16) at (row0, col0) of a tile: lane l addresses row
// l % 16, column block l / 16
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ROW + col0 + (lane >> 4) * 8);
}

// B operands of two n-tiles (rows n0..n0+15 of a tile whose rows are the
// product's columns, k columns k0..k0+15): b[0], b[1] for rows n0..n0+7,
// b[2], b[3] for rows n0+8..n0+15
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                       int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ROW + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B operands of two n-tiles from a tile whose rows are the reduction (k
// rows k0..k0+15, columns n0..n0+15), transposed: b[0], b[1] for columns
// n0..n0+7, b[2], b[3] for columns n0+8..n0+15
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                        int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW + n0 +
                           (lane >> 4) * 8);
}

__device__ __forceinline__ bool visible(int row, int key, int Lq, int Lk, int causal,
                                        int window) {
  return row < Lq && key < Lk && (!causal || key <= row) &&
         (window <= 0 || row - key < window);
}

// columns col, col + 1 of a row of `cols` (a multiple of 8, so a pair never
// straddles the end); nothing past the end
__device__ __forceinline__ void store2(__nv_bfloat16* row, int col, int cols, float x,
                                       float y) {
  if (col < cols) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
  }
}

// grid (query tiles, B * H), heaviest (last) query tiles first
__global__ void __launch_bounds__(THREADS, 2) fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int KVH, int Lq, int Lk, int causal, int window,
    int cols, float sm_scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ks = qs + FWD_Q * ROW;
  __nv_bfloat16* vs = ks + FWD_K * ROW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KVH + h / (H / KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows r0 and r0 + 8
  load_rows(qs, q + ((size_t)bh * Lq + q0) * cols, FWD_Q, Lq - q0, cols);
  const int q_last = min(q0 + FWD_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float c = sm_scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int k0 = k_lo / FWD_K * FWD_K; k0 < k_hi; k0 += FWD_K) {
    __syncthreads();  // every warp is done with the last tile
    load_rows(ks, k + (bkv * Lk + k0) * cols, FWD_K, Lk - k0, cols);
    load_rows(vs, v + (bkv * Lk + k0) * cols, FWD_K, Lk - k0, cols);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, qs, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        load_b(bb, ks, 16 * np, 16 * kk, lane);
        mma_m16n8k16(s[2 * np], a[0], a[1], a[2], a[3], bb[0], bb[1]);
        mma_m16n8k16(s[2 * np + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * tig + (e & 1);
        s[n][e] = visible(r0 + 8 * (e >> 1), key, Lq, Lk, causal, window)
                      ? s[n][e] * c : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      // a row with no visible key yet keeps m = -inf and adds nothing
      alpha[i] = m_new[i] == -INFINITY ? 1.f : exp2f(m[i] - m_new[i]);
      m[i] = m_new[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mi = m_new[e >> 1];
        s[n][e] = mi == -INFINITY ? 0.f : exp2f(s[n][e] - mi);
        l[e >> 1] += s[n][e];  // this thread's share of the row sum
      }
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: P (bf16) straight from the S layout
#pragma unroll
    for (int kk = 0; kk < FWD_K / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        load_bt(vb, vs, 16 * kk, 16 * dp, lane);
        mma_m16n8k16(o[2 * dp], a0, a1, a2, a3, vb[0], vb[1]);
        mma_m16n8k16(o[2 * dp + 1], a0, a1, a2, a3, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)bh * Lq + row) * cols;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      store2(orow, 8 * n + 2 * tig, cols, o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
    if (tig == 0) lse[(size_t)bh * Lq + row] = m[i] / LOG2E + logf(fmaxf(l[i], 1e-30f));
  }
}

// grid (query tiles, B * H), heaviest first
__global__ void __launch_bounds__(THREADS, 2) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int KVH, int Lq, int Lk, int causal, int window,
    int cols, float sm_scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* dos = qs + DQ_Q * ROW;
  __nv_bfloat16* ks = dos + DQ_Q * ROW;
  __nv_bfloat16* vs = ks + DQ_K * ROW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t bkv = (size_t)b * KVH + h / (H / KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + 16 * warp + g;
  load_rows(qs, q + ((size_t)bh * Lq + q0) * cols, DQ_Q, Lq - q0, cols);
  load_rows(dos, dout + ((size_t)bh * Lq + q0) * cols, DQ_Q, Lq - q0, cols);
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < Lq ? lse[(size_t)bh * Lq + row] * LOG2E : 0.f;
    dlt[i] = row < Lq ? delta[(size_t)bh * Lq + row] : 0.f;
  }
  const int q_last = min(q0 + DQ_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float c = sm_scale * LOG2E;
  float acc[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = k_lo / DQ_K * DQ_K; k0 < k_hi; k0 += DQ_K) {
    __syncthreads();
    load_rows(ks, k + (bkv * Lk + k0) * cols, DQ_K, Lk - k0, cols);
    load_rows(vs, v + (bkv * Lk + k0) * cols, DQ_K, Lk - k0, cols);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ga[4];
      load_a(a, qs, 16 * warp, 16 * kk, lane);
      load_a(ga, dos, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t kb[4], vb[4];
        load_b(kb, ks, 16 * np, 16 * kk, lane);
        load_b(vb, vs, 16 * np, 16 * kk, lane);
        mma_m16n8k16(s[2 * np], a[0], a[1], a[2], a[3], kb[0], kb[1]);
        mma_m16n8k16(s[2 * np + 1], a[0], a[1], a[2], a[3], kb[2], kb[3]);
        mma_m16n8k16(dp[2 * np], ga[0], ga[1], ga[2], ga[3], vb[0], vb[1]);
        mma_m16n8k16(dp[2 * np + 1], ga[0], ga[1], ga[2], ga[3], vb[2], vb[3]);
      }
    }
    // dS = P (dP - delta) scale, in the S layout
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + 8 * n + 2 * tig + (e & 1);
        const float p = visible(r0 + 8 * i, key, Lq, Lk, causal, window)
                            ? exp2f(s[n][e] * c - lse2[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - dlt[i]) * sm_scale;
      }
    }
    // dQ += dS K: K read transposed (its rows are the reduction)
#pragma unroll
    for (int kk = 0; kk < DQ_K / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t kb[4];
        load_bt(kb, ks, 16 * kk, 16 * dp2, lane);
        mma_m16n8k16(acc[2 * dp2], a0, a1, a2, a3, kb[0], kb[1]);
        mma_m16n8k16(acc[2 * dp2 + 1], a0, a1, a2, a3, kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Lq) continue;
    __nv_bfloat16* drow = dq + ((size_t)bh * Lq + row) * cols;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      store2(drow, 8 * n + 2 * tig, cols, acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// grid (key tiles, B * KVH, DKDV_SPLIT column blocks of the output)
__global__ void __launch_bounds__(DKDV_THREADS, 2) dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int KVH,
    int Lq, int Lk, int causal, int window, int cols, float sm_scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* vs = ks + DKDV_K * ROW;
  __nv_bfloat16* qs = vs + DKDV_K * ROW;
  __nv_bfloat16* dos = qs + DKDV_Q * ROW;
  float* lse2s = reinterpret_cast<float*>(dos + DKDV_Q * ROW);
  float* dlts = lse2s + DKDV_Q;
  const int bkv = blockIdx.y, b = bkv / KVH, grp = bkv % KVH, rep = H / KVH;
  const int k0 = blockIdx.x * DKDV_K, col0 = blockIdx.z * DKDV_COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int key0 = k0 + 16 * warp + g;  // this thread's keys key0 and key0 + 8
  load_rows<DKDV_THREADS>(ks, k + ((size_t)bkv * Lk + k0) * cols, DKDV_K, Lk - k0, cols);
  load_rows<DKDV_THREADS>(vs, v + ((size_t)bkv * Lk + k0) * cols, DKDV_K, Lk - k0, cols);
  const int k_last = min(k0 + DKDV_K, Lk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Lq, k_last + window) : Lq;
  const float c = sm_scale * LOG2E;
  float adk[DKDV_COLS / 8][4], adv[DKDV_COLS / 8][4];
#pragma unroll
  for (int n = 0; n < DKDV_COLS / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  }
  for (int r = 0; r < rep; ++r) {
    const size_t bh = (size_t)b * H + grp * rep + r;
    for (int q0 = q_lo / DKDV_Q * DKDV_Q; q0 < q_hi; q0 += DKDV_Q) {
      __syncthreads();  // every warp is done with the last query tile
      load_rows<DKDV_THREADS>(qs, q + (bh * Lq + q0) * cols, DKDV_Q, Lq - q0, cols);
      load_rows<DKDV_THREADS>(dos, dout + (bh * Lq + q0) * cols, DKDV_Q, Lq - q0, cols);
      for (int i = threadIdx.x; i < DKDV_Q; i += DKDV_THREADS) {
        const bool in = q0 + i < Lq;
        lse2s[i] = in ? lse[bh * Lq + q0 + i] * LOG2E : 0.f;
        dlts[i] = in ? delta[bh * Lq + q0 + i] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys by 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], va[4];
        load_a(a, ks, 16 * warp, 16 * kk, lane);
        load_a(va, vs, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4], gb[4];
          load_b(qb, qs, 16 * np, 16 * kk, lane);
          load_b(gb, dos, 16 * np, 16 * kk, lane);
          mma_m16n8k16(s[2 * np], a[0], a[1], a[2], a[3], qb[0], qb[1]);
          mma_m16n8k16(s[2 * np + 1], a[0], a[1], a[2], a[3], qb[2], qb[3]);
          mma_m16n8k16(dp[2 * np], va[0], va[1], va[2], va[3], gb[0], gb[1]);
          mma_m16n8k16(dp[2 * np + 1], va[0], va[1], va[2], va[3], gb[2], gb[3]);
        }
      }
      // P^T and dS^T, in place: column j of the layout is query q0 + j
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * tig + (e & 1);
          const float p = visible(q0 + j, key0 + 8 * (e >> 1), Lq, Lk, causal, window)
                              ? exp2f(s[n][e] * c - lse2s[j]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dlts[j]) * sm_scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q over this block's columns,
      // dO and Q read transposed (their rows are the reduction)
#pragma unroll
      for (int kk = 0; kk < DKDV_Q / 16; ++kk) {
        const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const uint32_t d0 = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        const uint32_t d1 = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        const uint32_t d2 = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        const uint32_t d3 = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < DKDV_COLS / 16; ++np) {
          uint32_t gb[4], qb[4];
          load_bt(gb, dos, 16 * kk, col0 + 16 * np, lane);
          load_bt(qb, qs, 16 * kk, col0 + 16 * np, lane);
          mma_m16n8k16(adv[2 * np], p0, p1, p2, p3, gb[0], gb[1]);
          mma_m16n8k16(adv[2 * np + 1], p0, p1, p2, p3, gb[2], gb[3]);
          mma_m16n8k16(adk[2 * np], d0, d1, d2, d3, qb[0], qb[1]);
          mma_m16n8k16(adk[2 * np + 1], d0, d1, d2, d3, qb[2], qb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Lk) continue;
    const size_t at = ((size_t)bkv * Lk + key) * cols;
#pragma unroll
    for (int n = 0; n < DKDV_COLS / 8; ++n) {
      const int col = col0 + 8 * n + 2 * tig;
      store2(dk + at, col, cols, adk[n][2 * i], adk[n][2 * i + 1]);
      store2(dv + at, col, cols, adv[n][2 * i], adv[n][2 * i + 1]);
    }
  }
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int smem) {
  // above the 48 KB default: opt in (cheap to repeat)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// cols: the head dim, a multiple of 8 up to 256 (the columns past it are
// zeros in shared memory and are not stored)
inline bool valid_cols(int cols) { return cols >= 8 && cols <= D && cols % 8 == 0; }

inline cudaError_t fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int B, int H, int KVH, int Lq, int Lk, int causal, int window,
                       int cols, float sm_scale, cudaStream_t stream) {
  if (!valid_cols(cols)) return cudaErrorInvalidValue;
  cudaError_t err = prepare(fwd_kernel, FWD_SMEM);
  if (err != cudaSuccess) return err;
  fwd_kernel<<<dim3((Lq + FWD_Q - 1) / FWD_Q, B * H), THREADS, FWD_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, KVH, Lq, Lk, causal, window, cols, sm_scale);
  return cudaGetLastError();
}

inline cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq_out, int B, int H,
                      int KVH, int Lq, int Lk, int causal, int window, int cols,
                      float sm_scale, cudaStream_t stream) {
  if (!valid_cols(cols)) return cudaErrorInvalidValue;
  cudaError_t err = prepare(dq_kernel, DQ_SMEM);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((Lq + DQ_Q - 1) / DQ_Q, B * H), THREADS, DQ_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq_out), H, KVH, Lq, Lk, causal, window, cols,
      sm_scale);
  return cudaGetLastError();
}

inline cudaError_t dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B,
                        int H, int KVH, int Lq, int Lk, int causal, int window,
                        int cols, float sm_scale, cudaStream_t stream) {
  if (!valid_cols(cols)) return cudaErrorInvalidValue;
  cudaError_t err = prepare(dkdv_kernel, DKDV_SMEM);
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((Lk + DKDV_K - 1) / DKDV_K, B * KVH, DKDV_SPLIT), DKDV_THREADS,
                DKDV_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, KVH, Lq, Lk,
      causal, window, cols, sm_scale);
  return cudaGetLastError();
}

}  // namespace flash_mma
