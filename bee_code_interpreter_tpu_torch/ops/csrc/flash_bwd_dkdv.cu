// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 inputs, f32
// statistics and accumulation, GQA-native (dK/dV summed over the query heads
// of each KV group and written compact), causal or full, optional sliding
// window.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/flash_attention.py
// `_bwd_dkdv_kernel` (:291), reached through `_flash_bwd_pallas` (:409). What
// it computes is the same: per key, over the visible (query head of the
// group, query row) pairs,
//   P  = exp(S * scale - lse), forced to 0 on invalid pairs (:271-288),
//   dV = sum P^T dO,
//   dK = sum dS^T Q with dS = P * (dP - delta) * scale, dP = dO V^T,
// with delta = rowsum(dO * O) - g_lse computed by the caller. What it does not
// carry over is the TPU's tiling: the sequential (rep, q-block) grid
// dimensions become the loops inside the block, there is no padding of L to a
// block multiple and no 512-block cap; the kernel masks its own ragged edge
// (rows >= Lq, keys >= Lk) and skips query tiles entirely above the causal
// diagonal or above the window (the same conditions as :317-320).
//
// Bound on this card: operations. Four products of D = 128 per visible pair
// (S, dP, dV, dK), 8 * pairs * D flops per query head. So the products run on
// the tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulation. One
// block is 4 warps over 64 keys of one (batch, KV head); each warp owns 16
// keys and holds their dK and dV rows (16 x 128 each) in f32 registers across
// the whole loop, then writes them once: no atomics, deterministic. The block
// computes the transposed score tile S^T = K Q^T (K as the A operand), so
// P^T and dS^T come out of the accumulators already laid out as the A
// operands of dV += P^T dO and dK += dS^T Q (rounded to bf16, as the forward
// rounds P for P V; the JAX kernel keeps them in f32). dO and Q are then the
// B operands read transposed from shared memory by ldmatrix.trans. Register
// pressure is what shapes the tiles: the two accumulators take 128 registers
// a thread, so the query tile is 32 rows (S^T and dP^T take 32 more) and the
// K and V tiles stay in shared memory instead of registers; the 64-key K/V
// tiles plus 32-row Q/dO tiles need 52.5 KB of dynamic shared memory.
// This is the simple version: no cp.async/TMA pipelining and no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_K = 64;              // keys per block: 4 warps x 16
constexpr int BLOCK_Q = 32;              // query rows per shared-memory tile
constexpr int HEAD_DIM = 128;
constexpr int THREADS = 128;
constexpr int STRIDE = HEAD_DIM + 8;     // bf16 per staged row (272 B)
constexpr int SMEM_BYTES =
    (2 * BLOCK_K + 2 * BLOCK_Q) * STRIDE * 2 + 2 * BLOCK_Q * 4;

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

// rows [r0, r0 + n) of a [L, D] head into a shared tile, zero past L
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int n, int L, int tid) {
  for (int i = tid; i < n * (HEAD_DIM / 8); i += THREADS) {
    const int r = i / (HEAD_DIM / 8), c = (i % (HEAD_DIM / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HEAD_DIM + c);
    }
    *reinterpret_cast<uint4*>(&dst[r * STRIDE + c]) = val;
  }
}

__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q,     // [B, H, Lq, D]
    const __nv_bfloat16* __restrict__ k,     // [B, KVH, Lk, D]
    const __nv_bfloat16* __restrict__ v,     // [B, KVH, Lk, D]
    const __nv_bfloat16* __restrict__ dout,  // [B, H, Lq, D]
    const float* __restrict__ lse,           // [B, H, Lq]
    const float* __restrict__ delta,         // [B, H, Lq]
    __nv_bfloat16* __restrict__ dk,          // [B, KVH, Lk, D]
    __nv_bfloat16* __restrict__ dv,          // [B, KVH, Lk, D]
    int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BLOCK_K * STRIDE;
  __nv_bfloat16* Qs = Vs + BLOCK_K * STRIDE;
  __nv_bfloat16* Ds = Qs + BLOCK_Q * STRIDE;  // dO
  float* lse_s = reinterpret_cast<float*>(Ds + BLOCK_Q * STRIDE);
  float* del_s = lse_s + BLOCK_Q;

  const int bkv = blockIdx.y;  // b * KVH + kv head
  const int b = bkv / KVH;
  const int kv_head = bkv % KVH;
  const int rep = H / KVH;
  const int k0 = blockIdx.x * BLOCK_K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group / column pair

  // this thread's two keys
  const int key0 = k0 + warp * 16 + g;
  const int key1 = key0 + 8;

  const __nv_bfloat16* kb = k + (size_t)bkv * Lk * HEAD_DIM;
  const __nv_bfloat16* vb = v + (size_t)bkv * Lk * HEAD_DIM;
  stage_rows(Ks, kb, k0, BLOCK_K, Lk, tid);
  stage_rows(Vs, vb, k0, BLOCK_K, Lk, tid);

  // query rows that see any key of this block: at or after the first key
  // when causal, before the last key + window with a sliding window
  const int k_last = min(k0 + BLOCK_K, Lk) - 1;
  const int row_lo = causal ? k0 : 0;
  const int row_hi = window > 0 ? min(Lq, k_last + window) : Lq;
  const int t_lo = row_lo / BLOCK_Q;
  const int t_hi = row_hi > row_lo ? (row_hi + BLOCK_Q - 1) / BLOCK_Q : t_lo;

  float dka[16][4], dva[16][4];
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }
  // this warp's 16 K and V rows in shared memory (A operands)
  const __nv_bfloat16* kw = Ks + (warp * 16 + g) * STRIDE + t4 * 2;
  const __nv_bfloat16* vw = Vs + (warp * 16 + g) * STRIDE + t4 * 2;

  for (int r = 0; r < rep; ++r) {
    const size_t bh = (size_t)b * H + kv_head * rep + r;
    const __nv_bfloat16* qb = q + bh * Lq * HEAD_DIM;
    const __nv_bfloat16* db = dout + bh * Lq * HEAD_DIM;
    for (int t = t_lo; t < t_hi; ++t) {
      const int qbase = t * BLOCK_Q;
      __syncthreads();  // the previous tile is consumed by every warp
      stage_rows(Qs, qb, qbase, BLOCK_Q, Lq, tid);
      stage_rows(Ds, db, qbase, BLOCK_Q, Lq, tid);
      if (tid < BLOCK_Q) {
        const bool in = qbase + tid < Lq;
        lse_s[tid] = in ? lse[bh * Lq + qbase + tid] : 0.f;
        del_s[tid] = in ? delta[bh * Lq + qbase + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 rows per warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        uint32_t ka[4], va[4];
        ka[0] = load_u32(kw + ks * 16);
        ka[1] = load_u32(kw + 8 * STRIDE + ks * 16);
        ka[2] = load_u32(kw + ks * 16 + 8);
        ka[3] = load_u32(kw + 8 * STRIDE + ks * 16 + 8);
        va[0] = load_u32(vw + ks * 16);
        va[1] = load_u32(vw + 8 * STRIDE + ks * 16);
        va[2] = load_u32(vw + ks * 16 + 8);
        va[3] = load_u32(vw + 8 * STRIDE + ks * 16 + 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int off = (nt * 8 + g) * STRIDE + ks * 16 + t4 * 2;
          mma_bf16(s[nt], ka, load_u32(&Qs[off]), load_u32(&Qs[off + 8]));
          mma_bf16(dp[nt], va, load_u32(&Ds[off]), load_u32(&Ds[off + 8]));
        }
      }

      // P^T, forced to 0 on invalid pairs, in s; dS^T in dp
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = nt * 8 + t4 * 2 + i;
          const int row = qbase + qi;
          bool ok0 = row < Lq && key0 < Lk, ok1 = row < Lq && key1 < Lk;
          if (causal) {
            ok0 = ok0 && row >= key0;
            ok1 = ok1 && row >= key1;
          }
          if (window > 0) {
            ok0 = ok0 && row - key0 < window;
            ok1 = ok1 && row - key1 < window;
          }
          const float l = lse_s[qi], d = del_s[qi];
          const float p0 = ok0 ? __expf(s[nt][i] * sm_scale - l) : 0.f;
          const float p1 = ok1 ? __expf(s[nt][2 + i] * sm_scale - l) : 0.f;
          s[nt][i] = p0;
          s[nt][2 + i] = p1;
          dp[nt][i] = p0 * (dp[nt][i] - d) * sm_scale;
          dp[nt][2 + i] = p1 * (dp[nt][2 + i] - d) * sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over 2 steps of 16 rows; dO and Q
      // read transposed
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, &Ds[(kk * 16) * STRIDE + dn * 16], lane);
          mma_bf16(dva[2 * dn], pa, bf[0], bf[1]);
          mma_bf16(dva[2 * dn + 1], pa, bf[2], bf[3]);
          ldmatrix_x4_trans(bf, &Qs[(kk * 16) * STRIDE + dn * 16], lane);
          mma_bf16(dka[2 * dn], da, bf[0], bf[1]);
          mma_bf16(dka[2 * dn + 1], da, bf[2], bf[3]);
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + (size_t)bkv * Lk * HEAD_DIM;
  __nv_bfloat16* dvb = dv + (size_t)bkv * Lk * HEAD_DIM;
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (key0 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key0 * HEAD_DIM + c) =
          pack_bf16(dka[dn][0], dka[dn][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key0 * HEAD_DIM + c) =
          pack_bf16(dva[dn][0], dva[dn][1]);
    }
    if (key1 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)key1 * HEAD_DIM + c) =
          pack_bf16(dka[dn][2], dka[dn][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)key1 * HEAD_DIM + c) =
          pack_bf16(dva[dn][2], dva[dn][3]);
    }
  }
}

}  // namespace

// window <= 0 means no sliding window. Returns the launch's cudaError_t.
extern "C" int bci_flash_bwd_dkdv_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H, int KVH,
                                       int Lq, int Lk, int causal, int window,
                                       float sm_scale, void* stream) {
  // above the 48 KB default: opt in once per process (cheap to repeat)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BLOCK_K - 1) / BLOCK_K, B * KVH);
  flash_bwd_dkdv_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, KVH, Lq, Lk, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
