// Flash-attention forward for Hopper (sm_90a): bf16 inputs, f32 statistics,
// GQA-native, causal or full, optional sliding window, returns out and lse.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/flash_attention.py
// `_fwd_kernel` (:48), reached through `_flash_fwd` (:170). What it computes
// is the same: per query row, the online softmax over the visible keys, with
// lse = m + log(max(l, 1e-30)) (flash_attention.py:119-121). What it does not
// carry over is the TPU's tiling: the sequential k grid dimension becomes the
// loop inside the block, and there is no padding of L to a block multiple
// (`_compatible_blocks`, `_padded_len`, `_round_up`): the kernel masks its own
// ragged edge (keys >= Lk, query rows >= Lq).
//
// Bound on this card: operations. Causal prefill at L = 1024, D = 128 does
// 2*L*L*D multiply-adds per head, far above the ~295 operations per byte
// where an H100 stops being memory bound. So the design keeps the products on
// the tensor cores: mma.sync m16n8k16 with bf16 operands and f32
// accumulation (S = Q K^T and O += P V), P kept in registers between the two
// products (the S accumulator fragments are exactly P's A-operand layout), and
// tiles entirely above the causal diagonal or below the window skipped.
// One block is 4 warps over 64 query rows of one (batch, head); each warp owns
// 16 rows. K (64 x 128) and V (transposed to 128 x 64) tiles are staged in
// shared memory, rows padded so the fragment reads are free of bank
// conflicts. The K/V head of query head h is h / (H / KVH): no K/V repeat.
// This is the simple version: no cp.async/TMA pipelining and no wgmma, so it
// reaches a fraction of the tensor-core peak (see PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;              // query rows per block: 4 warps x 16
constexpr int BLOCK_K = 64;              // keys per shared-memory tile
constexpr int HEAD_DIM = 128;
constexpr int THREADS = 128;
constexpr int K_STRIDE = HEAD_DIM + 8;   // bf16 per K row in smem (272 B)
constexpr int VT_STRIDE = BLOCK_K + 8;   // bf16 per transposed V row (144 B)

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

__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, Lq, D]
    const __nv_bfloat16* __restrict__ k,  // [B, KVH, Lk, D]
    const __nv_bfloat16* __restrict__ v,  // [B, KVH, Lk, D]
    __nv_bfloat16* __restrict__ out,      // [B, H, Lq, D]
    float* __restrict__ lse,              // [B, H, Lq]
    int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BLOCK_K * K_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Vt[HEAD_DIM * VT_STRIDE];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv_head = (bh % H) / (H / KVH);
  const int q0 = blockIdx.x * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group / column pair

  const __nv_bfloat16* qb = q + (size_t)bh * Lq * HEAD_DIM;
  const __nv_bfloat16* kb = k + (size_t)(b * KVH + kv_head) * Lk * HEAD_DIM;
  const __nv_bfloat16* vb = v + (size_t)(b * KVH + kv_head) * Lk * HEAD_DIM;

  // this thread's two query rows
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  // Q as A fragments for the 8 steps of 16 over D, kept for the whole block
  uint32_t qf[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qf[ks][0] = row0 < Lq ? load_u32(qb + (size_t)row0 * HEAD_DIM + c) : 0u;
    qf[ks][1] = row1 < Lq ? load_u32(qb + (size_t)row1 * HEAD_DIM + c) : 0u;
    qf[ks][2] = row0 < Lq ? load_u32(qb + (size_t)row0 * HEAD_DIM + c + 8) : 0u;
    qf[ks][3] = row1 < Lq ? load_u32(qb + (size_t)row1 * HEAD_DIM + c + 8) : 0u;
  }

  // keys any row of this block can see: skip tiles above the causal
  // diagonal and below the sliding window
  const int q_last = min(q0 + BLOCK_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BLOCK_K;
  const int t_hi = (k_hi + BLOCK_K - 1) / BLOCK_K;

  float o[16][4];
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int kbase = t * BLOCK_K;
    __syncthreads();  // the previous tile is consumed by every warp
    // K tile, row-major: 16 threads cover one 256-byte key row
    for (int i = tid; i < BLOCK_K * (HEAD_DIM / 8); i += THREADS) {
      const int r = i / (HEAD_DIM / 8), c = (i % (HEAD_DIM / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kbase + r < Lk) {
        val = *reinterpret_cast<const uint4*>(kb + (size_t)(kbase + r) * HEAD_DIM + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * K_STRIDE + c]) = val;
    }
    // V tile transposed to Vt[d][key]: neighbouring threads take
    // neighbouring keys so the scattered 2-byte stores do not collide
    for (int i = tid; i < BLOCK_K * (HEAD_DIM / 8); i += THREADS) {
      const int r = i % BLOCK_K, c = (i / BLOCK_K) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kbase + r < Lk) {
        val = *reinterpret_cast<const uint4*>(vb + (size_t)(kbase + r) * HEAD_DIM + c);
      }
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_STRIDE + r] = e[j];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * K_STRIDE + ks * 16 + t4 * 2];
        mma_bf16(s[nt], qf[ks], load_u32(kp), load_u32(kp + 8));
      }
    }

    // scale and mask; row maxima over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = kbase + nt * 8 + t4 * 2 + i;
        bool ok0 = col < Lk, ok1 = col < Lk;
        if (causal) {
          ok0 = ok0 && row0 >= col;
          ok1 = ok1 && row1 >= col;
        }
        if (window > 0) {
          ok0 = ok0 && row0 - col < window;
          ok1 = ok1 && row1 - col < window;
        }
        s[nt][i] = ok0 ? s[nt][i] * sm_scale : -INFINITY;
        s[nt][2 + i] = ok1 ? s[nt][2 + i] * sm_scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][i]);
        mx1 = fmaxf(mx1, s[nt][2 + i]);
      }
    }
    // the 4 threads of a row group hold the row's 64 keys between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no visible key yet subtracts 0, so exp(-inf) gives p = 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = __expf(m0 - base0), alpha1 = __expf(m1 - base1);

    // P = exp(S - m) in f32 for the normalizer, bf16 A fragments for P V
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - base0);
      s[nt][1] = __expf(s[nt][1] - base0);
      s[nt][2] = __expf(s[nt][2] - base1);
      s[nt][3] = __expf(s[nt][3] - base1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    m0 = mn0;
    m1 = mn1;

#pragma unroll
    for (int dn = 0; dn < 16; ++dn) {
      o[dn][0] *= alpha0;
      o[dn][1] *= alpha0;
      o[dn][2] *= alpha1;
      o[dn][3] *= alpha1;
    }
    // O += P V over 4 steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < 16; ++dn) {
        const __nv_bfloat16* vp = &Vt[(dn * 8 + g) * VT_STRIDE + kk * 16 + t4 * 2];
        mma_bf16(o[dn], pf, load_u32(vp), load_u32(vp + 8));
      }
    }
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  __nv_bfloat16* ob = out + (size_t)bh * Lq * HEAD_DIM;
#pragma unroll
  for (int dn = 0; dn < 16; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (row0 < Lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * HEAD_DIM + c) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    }
    if (row1 < Lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * HEAD_DIM + c) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
  if (t4 == 0) {
    if (row0 < Lq) lse[(size_t)bh * Lq + row0] = m0 + logf(lc0);
    if (row1 < Lq) lse[(size_t)bh * Lq + row1] = m1 + logf(lc1);
  }
}

}  // namespace

// window <= 0 means no sliding window. Returns the launch's cudaError_t.
extern "C" int bci_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int KVH,
                                  int Lq, int Lk, int causal, int window,
                                  float sm_scale, void* stream) {
  dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, B * H);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, KVH, Lq, Lk, causal, window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
