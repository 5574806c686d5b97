// Flash-attention backward, dQ, for Hopper (sm_90a): bf16 inputs, f32
// statistics and accumulation, GQA-native, causal or full, optional sliding
// window.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (:357), reached through `_flash_bwd_pallas` (:409). What it
// computes is the same: per query row, over the visible keys,
//   P  = exp(S * scale - lse), forced to 0 on invalid pairs (:271-288),
//   dS = P * (dP - delta) * scale with dP = dO V^T,
//   dQ = sum over keys of dS K,
// with delta = rowsum(dO * O) - g_lse computed by the caller. What it does not
// carry over is the TPU's tiling: the sequential k grid dimension becomes the
// loop inside the block, there is no padding of L to a block multiple and no
// 512-block cap; the kernel masks its own ragged edge (rows >= Lq, keys >= Lk)
// and skips key tiles entirely above the causal diagonal or below the window
// (the same conditions as :378-381).
//
// Bound on this card: operations. Three products of D = 128 per visible
// (query, key) pair (S, dP, dQ), 6 * pairs * D flops per head, against a
// read of q, k, v, dO once. So the products run on the tensor cores:
// mma.sync m16n8k16, bf16 operands, f32 accumulation. One block is 4 warps
// over 64 query rows of one (batch, head); each warp owns 16 rows and keeps
// its Q and dO rows as A fragments in registers for the whole block. K and V
// tiles of 32 keys are staged in shared memory (rows padded so the fragment
// reads are free of bank conflicts). The S and dP accumulator fragments are
// exactly the A-operand layout of the next product, so dS stays in registers
// (rounded to bf16, as the forward rounds P for P V; the JAX kernel keeps it
// in f32); K is the B operand of dQ += dS K read transposed from the same
// shared tile by ldmatrix.trans. No atomics: each block writes its rows once.
// This is the simple version: no cp.async/TMA pipelining and no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;              // query rows per block: 4 warps x 16
constexpr int BLOCK_K = 32;              // keys per shared-memory tile
constexpr int HEAD_DIM = 128;
constexpr int THREADS = 128;
constexpr int STRIDE = HEAD_DIM + 8;     // bf16 per staged row (272 B)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one m16n8k16 tile (bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two neighbouring n8 tiles for one k16 step, from a
// row-major [k][n] tile in shared memory: four 8x8 matrices loaded
// transposed. `tile` points at element (k0, n0); lane l addresses row
// k0 + (l & 7) + 8 * ((l >> 3) & 1) at column n0 + 8 * (l >> 4). r[0], r[1]
// are b0b1 / b2b3 of n-tile n0, r[2], r[3] those of n-tile n0 + 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* tile,
                                                  int lane) {
  const __nv_bfloat16* p =
      tile + ((lane & 7) + 8 * ((lane >> 3) & 1)) * STRIDE + 8 * (lane >> 4);
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q,     // [B, H, Lq, D]
    const __nv_bfloat16* __restrict__ k,     // [B, KVH, Lk, D]
    const __nv_bfloat16* __restrict__ v,     // [B, KVH, Lk, D]
    const __nv_bfloat16* __restrict__ dout,  // [B, H, Lq, D]
    const float* __restrict__ lse,           // [B, H, Lq]
    const float* __restrict__ delta,         // [B, H, Lq]
    __nv_bfloat16* __restrict__ dq,          // [B, H, Lq, D]
    int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_K * STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Vs[BLOCK_K * STRIDE];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv_head = (bh % H) / (H / KVH);
  const int q0 = blockIdx.x * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group / column pair

  const __nv_bfloat16* qb = q + (size_t)bh * Lq * HEAD_DIM;
  const __nv_bfloat16* db = dout + (size_t)bh * Lq * HEAD_DIM;
  const __nv_bfloat16* kb = k + (size_t)(b * KVH + kv_head) * Lk * HEAD_DIM;
  const __nv_bfloat16* vb = v + (size_t)(b * KVH + kv_head) * Lk * HEAD_DIM;

  // this thread's two query rows
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool in0 = row0 < Lq, in1 = row1 < Lq;

  // Q and dO rows as A fragments for the 8 steps of 16 over D
  uint32_t qf[8][4], df[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qf[ks][0] = in0 ? load_u32(qb + (size_t)row0 * HEAD_DIM + c) : 0u;
    qf[ks][1] = in1 ? load_u32(qb + (size_t)row1 * HEAD_DIM + c) : 0u;
    qf[ks][2] = in0 ? load_u32(qb + (size_t)row0 * HEAD_DIM + c + 8) : 0u;
    qf[ks][3] = in1 ? load_u32(qb + (size_t)row1 * HEAD_DIM + c + 8) : 0u;
    df[ks][0] = in0 ? load_u32(db + (size_t)row0 * HEAD_DIM + c) : 0u;
    df[ks][1] = in1 ? load_u32(db + (size_t)row1 * HEAD_DIM + c) : 0u;
    df[ks][2] = in0 ? load_u32(db + (size_t)row0 * HEAD_DIM + c + 8) : 0u;
    df[ks][3] = in1 ? load_u32(db + (size_t)row1 * HEAD_DIM + c + 8) : 0u;
  }
  const float lse0 = in0 ? lse[(size_t)bh * Lq + row0] : 0.f;
  const float lse1 = in1 ? lse[(size_t)bh * Lq + row1] : 0.f;
  const float del0 = in0 ? delta[(size_t)bh * Lq + row0] : 0.f;
  const float del1 = in1 ? delta[(size_t)bh * Lq + row1] : 0.f;

  // keys any row of this block can see: skip tiles above the causal
  // diagonal and below the sliding window
  const int q_last = min(q0 + BLOCK_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BLOCK_K;
  const int t_hi = (k_hi + BLOCK_K - 1) / BLOCK_K;

  float acc[16][4];
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int kbase = t * BLOCK_K;
    __syncthreads();  // the previous tile is consumed by every warp
    // K and V tiles, row-major: 16 threads cover one 256-byte key row
    for (int i = tid; i < BLOCK_K * (HEAD_DIM / 8); i += THREADS) {
      const int r = i / (HEAD_DIM / 8), c = (i % (HEAD_DIM / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kbase + r < Lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(kbase + r) * HEAD_DIM + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(kbase + r) * HEAD_DIM + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * STRIDE + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * STRIDE + c]) = vv;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 32 keys per warp, 4 tiles of 8
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int off = (nt * 8 + g) * STRIDE + ks * 16 + t4 * 2;
        mma_bf16(s[nt], qf[ks], load_u32(&Ks[off]), load_u32(&Ks[off + 8]));
        mma_bf16(dp[nt], df[ks], load_u32(&Vs[off]), load_u32(&Vs[off + 8]));
      }
    }

    // P, forced to 0 on invalid pairs, then dS = P (dP - delta) scale in s
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = kbase + nt * 8 + t4 * 2 + i;
        bool ok0 = in0 && col < Lk, ok1 = in1 && col < Lk;
        if (causal) {
          ok0 = ok0 && row0 >= col;
          ok1 = ok1 && row1 >= col;
        }
        if (window > 0) {
          ok0 = ok0 && row0 - col < window;
          ok1 = ok1 && row1 - col < window;
        }
        const float p0 = ok0 ? __expf(s[nt][i] * sm_scale - lse0) : 0.f;
        const float p1 = ok1 ? __expf(s[nt][2 + i] * sm_scale - lse1) : 0.f;
        s[nt][i] = p0 * (dp[nt][i] - del0) * sm_scale;
        s[nt][2 + i] = p1 * (dp[nt][2 + i] - del1) * sm_scale;
      }
    }

    // dQ += dS K over 2 steps of 16 keys; K read transposed
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Ks[(kk * 16) * STRIDE + dn * 16], lane);
        mma_bf16(acc[2 * dn], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dn + 1], a, bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* ob = dq + (size_t)bh * Lq * HEAD_DIM;
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (in0) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * HEAD_DIM + c) =
          pack_bf16(acc[dn][0], acc[dn][1]);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * HEAD_DIM + c) =
          pack_bf16(acc[dn][2], acc[dn][3]);
    }
  }
}

}  // namespace

// window <= 0 means no sliding window. Returns the launch's cudaError_t.
extern "C" int bci_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int B, int H,
                                     int KVH, int Lq, int Lk, int causal,
                                     int window, float sm_scale, void* stream) {
  dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, B * H);
  flash_bwd_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H, KVH,
      Lq, Lk, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
