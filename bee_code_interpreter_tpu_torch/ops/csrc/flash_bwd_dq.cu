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
// 512-block cap; the 3-D TMA maps read rows past L as zeros within their
// head, the kernel forces P to 0 on rows >= Lq and keys >= Lk, the output
// store drops rows >= Lq, and key tiles entirely above the causal diagonal
// or below the window are skipped (the conditions of :378-381).
//
// Bound on this card: operations. Three products of D = 128 per visible
// (query, key) pair (S, dP, dQ), 6 * pairs * D flops per head, all on the
// tensor cores through wgmma. The design is K3's (flash_bwd_dkdv.cu) with the
// two sides swapped:
// - one block owns 128 query rows of one (batch, head): a producer
//   warpgroup (one thread starting the TMA loads; 24 registers by
//   setmaxnreg) and two consumer warpgroups of 64 rows each (240
//   registers);
// - Q and dO (128 x 128 each) are loaded once by TMA, each row's lse (times
//   log2 e) and delta once into registers; K and V tiles of 64 keys stream
//   through a three-stage ring under full/empty mbarriers;
// - S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in
//   shared memory, K-major;
// - P and dS are computed in registers (a mask only on tiles that touch the
//   diagonal, the window edge or a ragged end), dS rounded to bf16 as the A
//   operand, in registers, of dQ += dS K: wgmma m64n128k16 with K read
//   MN-major through the descriptor's transpose bit (K1's P V pattern over a
//   64-key box, K3's dO operand);
// - dQ accumulates in f32 registers (64 a thread) and is written once,
//   through the warpgroup's own (then idle) Q rows, by TMA store: no
//   atomics, two calls give the same bits;
// - the grid puts the heaviest q-tiles (the last, under causal masking)
//   first, and the query heads of one KV group next to each other, so the
//   blocks that read the same K/V tiles run together and find them in L2
//   (on an H100, 7 % faster than the natural order; a persistent version,
//   one block an SM walking the items as K1 does, measured no faster).
// What is left: no overlap inside a warpgroup of one tile's elementwise work
// with the next tile's products; P and dS are recomputed here and in K3.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_Q = 128;  // query rows per block: 2 consumer warpgroups x 64
constexpr int BLOCK_K = 64;   // keys per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;             // producer warpgroup + 2 consumers
constexpr int Q_BOX = BLOCK_Q * 128;     // one [128 rows][64] bf16 box
constexpr int Q_TILE = 2 * Q_BOX;        // [128][128] bf16
constexpr int KV_BOX = BLOCK_K * 128;    // one [64 keys][64] bf16 box
constexpr int KV_TILE = 2 * KV_BOX;      // [64][128] bf16
constexpr int STAGE_BYTES = 2 * KV_TILE; // K and V
constexpr int RING = 2 * Q_TILE;         // the ring follows Q and dO
constexpr int BARS = RING + STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // [B*H, Lq, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_k,   // [B*KVH, Lk, D], box 64 rows
    const __grid_constant__ CUtensorMap tm_v,   // [B*KVH, Lk, D], box 64 rows
    const __grid_constant__ CUtensorMap tm_do,  // [B*H, Lq, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_dq,  // [B*H, Lq, D], box 64 rows
    const float* __restrict__ lse,              // [B, H, Lq]
    const float* __restrict__ delta,            // [B, H, Lq]
    int BH, int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_tile = smem;
  unsigned char* do_tile = smem + Q_TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  auto k_stage = [&](int s) { return smem + RING + s * STAGE_BYTES; };
  auto v_stage = [&](int s) { return smem + RING + s * STAGE_BYTES + KV_TILE; };

  // work item: the last q-tiles first (the most key tiles under causal
  // masking), the heads of one KV group next to each other
  const int n_qt = (Lq + BLOCK_Q - 1) / BLOCK_Q;
  const int bh = blockIdx.x % BH;
  const int bkv = (bh / H) * KVH + (bh % H) / (H / KVH);
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * BLOCK_Q;
  // keys any row of this block can see: none above the causal diagonal,
  // none below the sliding window
  const int q_last = min(q0 + BLOCK_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / BLOCK_K;
  const int t_hi = k_hi > k_lo ? (k_hi + BLOCK_K - 1) / BLOCK_K : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_arrive_expect_tx(qd_full, 2 * Q_TILE);
      tma_load_3d(q_tile, &tm_q, qd_full, 0, q0, bh);
      tma_load_3d(q_tile + Q_BOX, &tm_q, qd_full, BOX_COLS, q0, bh);
      tma_load_3d(do_tile, &tm_do, qd_full, 0, q0, bh);
      tma_load_3d(do_tile + Q_BOX, &tm_do, qd_full, BOX_COLS, q0, bh);
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_3d(k_stage(s), &tm_k, &full[s], 0, t * BLOCK_K, bkv);
        tma_load_3d(k_stage(s) + KV_BOX, &tm_k, &full[s], BOX_COLS, t * BLOCK_K, bkv);
        tma_load_3d(v_stage(s), &tm_v, &full[s], 0, t * BLOCK_K, bkv);
        tma_load_3d(v_stage(s) + KV_BOX, &tm_v, &full[s], BOX_COLS, t * BLOCK_K, bkv);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64cw..
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + cw * 64;
    const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
    const float c = sm_scale * LOG2E;
    unsigned char* q_rows = q_tile + cw * 64 * 128;  // this warpgroup's rows in each box
    const unsigned char* do_rows = do_tile + cw * 64 * 128;
    const float lse_a = row_a < Lq ? lse[(size_t)bh * Lq + row_a] * LOG2E : 0.f;
    const float lse_b = row_b < Lq ? lse[(size_t)bh * Lq + row_b] * LOG2E : 0.f;
    const float del_a = row_a < Lq ? delta[(size_t)bh * Lq + row_a] : 0.f;
    const float del_b = row_b < Lq ? delta[(size_t)bh * Lq + row_b] : 0.f;

    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;

    mbar_wait(qd_full, 0);
    for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
      const int s = it % STAGES;
      const int kt0 = t * BLOCK_K;
      // no row of this warpgroup sees a key of this tile
      const bool skip = r0 >= Lq || (causal && kt0 > r0 + 63) ||
                        (window > 0 && r0 - (kt0 + BLOCK_K - 1) >= window);
      mbar_wait(&full[s], (it / STAGES) & 1);
      if (!skip) {
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_ss(sc, desc_k_major(q_rows, Q_BOX, kk),
                             desc_k_major(k_stage(s), KV_BOX, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_ss(dp, desc_k_major(do_rows, Q_BOX, kk),
                             desc_k_major(v_stage(s), KV_BOX, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // dS into dp; column j of the tile is key kt0 + j
        const bool unmasked = kt0 + BLOCK_K <= Lk && r0 + 64 <= Lq &&
                              (!causal || r0 >= kt0 + BLOCK_K - 1) &&
                              (window <= 0 || r0 + 63 - kt0 < window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float p_a = fast_exp2(fmaf(sc[4 * j + i], c, -lse_a));
            float p_b = fast_exp2(fmaf(sc[4 * j + 2 + i], c, -lse_b));
            if (!unmasked) {
              const int key = kt0 + j * 8 + t4 * 2 + i;
              bool ok_a = row_a < Lq && key < Lk, ok_b = row_b < Lq && key < Lk;
              if (causal) {
                ok_a = ok_a && row_a >= key;
                ok_b = ok_b && row_b >= key;
              }
              if (window > 0) {
                ok_a = ok_a && row_a - key < window;
                ok_b = ok_b && row_b - key < window;
              }
              p_a = ok_a ? p_a : 0.f;
              p_b = ok_b ? p_b : 0.f;
            }
            dp[4 * j + i] = p_a * (dp[4 * j + i] - del_a) * sm_scale;
            dp[4 * j + 2 + i] = p_b * (dp[4 * j + 2 + i] - del_b) * sm_scale;
          }
        }
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pack_a(da[kk], dp, kk);
          fence_regs(da[kk]);
        }
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n128k16_rs(dq, da[kk], desc_mn_major(k_stage(s), KV_BOX, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // out: through this warpgroup's Q rows (its products are done with them)
    if (r0 < Lq) {
      store_acc_64x128(dq, 1.f, 1.f, q_rows, Q_BOX, &tm_dq, r0, bh, 1 + cw);
    }
  }
}

}  // namespace

// window <= 0 means no sliding window. Returns the launch's cudaError_t
// (cudaErrorInvalidValue when a TMA map cannot be encoded: base not 16-byte
// aligned).
extern "C" int bci_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int B, int H,
                                     int KVH, int Lq, int Lk, int causal,
                                     int window, float sm_scale, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map_3d(&tm_q, q, B * H, Lq, BLOCK_Q) ||
      !make_map_3d(&tm_k, k, B * KVH, Lk, BLOCK_K) ||
      !make_map_3d(&tm_v, v, B * KVH, Lk, BLOCK_K) ||
      !make_map_3d(&tm_do, dout, B * H, Lq, BLOCK_Q) ||
      !make_map_3d(&tm_dq, dq, B * H, Lq, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above the 48 KB default: opt in (cheap to repeat)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Lq + BLOCK_Q - 1) / BLOCK_Q;
  flash_bwd_dq_kernel<<<n_qt * B * H, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), B * H, H, KVH, Lq, Lk, causal, window,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}
