// Flash-attention backward, dK and dV, for Hopper (sm_90a): bf16 inputs, f32
// statistics and accumulation, GQA-native (dK/dV summed over the query heads of
// each KV group and written compact), causal or full, optional sliding window.
// Head dim D = 64 or 128: the kernel is a template over NB = D / 64, the
// 64-column TMA boxes of a tile (entry points bci_flash_bwd_dkdv_bf16_d64 and
// bci_flash_bwd_dkdv_bf16; D = 128 is the design below, D = 64 the same with
// the K/V, Q and dO tiles, the ring and the dK/dV accumulators halved, S^T and
// dP^T in 4 k16 steps and dV/dK at N = 64). At ViT-B/16's shape (L = 196, D =
// 64, one head a group, non-causal) the work is bound by bytes (~234 MB against
// 30 GFLOP); the padded query rows' P is forced to 0. Every other head dim
// JAX's kernel takes runs too: bf16 at D < 128 that is a multiple of 8 is read
// in place through maps of D columns (the columns past D read as zeros, dropped
// on store), any other arrives zero-padded to 64 or 128 by the wrapper
// (ops/flash_attention.py); bf16 above 128 takes the warp-level tensor-core
// instance of flash_mma.cuh, f32 at every D <= 256 the CUDA-core kernel of
// flash_simt.cuh (entry points below).
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
// block multiple and no 512-block cap; the 3-D TMA maps read rows past L as
// zeros within their head, the kernel forces P to 0 on rows >= Lq and keys
// >= Lk, the output store drops keys >= Lk, and query tiles entirely above the
// causal diagonal or above the window are skipped (the conditions of
// :317-320).
//
// Bound on this card: operations. Four products of D = 128 per visible pair
// (S, dP, dV, dK), 8 * pairs * D flops per query head, all on the tensor
// cores through wgmma:
// - one block owns 128 keys of one (batch, KV head): a producer warpgroup
//   (one warp: TMA and the per-row statistics; 24 registers by setmaxnreg)
//   and two consumer warpgroups of 64 keys each (240 registers);
// - K and V (128 x 128 each) are loaded once by TMA; per (query head, 64-row
//   query tile) the Q and dO tiles (64 x 128 each) and the tile's lse (times
//   log2 e) and delta go through a three-stage ring under full/empty
//   mbarriers (1 % faster than two on an H100);
// - S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both operands in
//   shared memory, K-major;
// - P^T and dS^T are computed in registers (forced to 0 on invalid pairs; a
//   mask is computed only on tiles that touch the diagonal, the window edge or
//   a ragged end), rounded to bf16 as the A operands, in registers, of
//   dV += P^T dO and dK += dS^T Q: wgmma m64n128k16 with dO / Q read MN-major
//   through the descriptor's transpose bit;
// - dK and dV accumulate in f32 registers (2 x 64 a thread) across the loop
//   and are written once by TMA store: no atomics, deterministic;
// - balance: a block walks all the group's query heads, and under causal
//   masking the block of the first keys walks every query tile of each, so
//   when the grid fits in one wave its heaviest block sets the time. Then
//   the group's heads are split over a thread-block cluster of two (heads
//   r % 2 in block r % 2); at the end each block sends the half it does not
//   write (block 0 its dV, block 1 its dK) into the other's shared memory
//   (distributed shared memory), and block 0 writes dK, block 1 dV: a fixed
//   two-term sum, so the result stays deterministic, and no device-memory
//   traffic is added. The grid puts the heaviest key tiles (the first, under
//   causal masking) first.
// What is left: no overlap inside a warpgroup of one tile's elementwise work
// with the next tile's products, no turns between the two consumers; the
// dS^T tile is not shared with the dQ kernel (K4 recomputes P and dS).

#include <math.h>

#include "flash_mma.cuh"
#include "flash_simt.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_K = 128;  // keys per block: 2 consumer warpgroups x 64
constexpr int BLOCK_Q = 64;   // query rows per ring stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;            // producer warpgroup + 2 consumers
constexpr int KV_BOX = BLOCK_K * 128;   // one [128 keys][64] bf16 box
constexpr int Q_BOX = BLOCK_Q * 128;    // one [64 rows][64] bf16 box
constexpr float LOG2E = 1.4426950408889634f;

// shared memory at NB boxes a tile
template <int NB>
struct Layout {
  static constexpr int KV_TILE = NB * KV_BOX;     // [128][D] bf16
  static constexpr int Q_TILE = NB * Q_BOX;       // [64][D] bf16
  static constexpr int STAGE_BYTES = 2 * Q_TILE;  // Q and dO
  static constexpr int RING = 2 * KV_TILE;        // the ring follows K and V
  static constexpr int STATS = RING + STAGES * STAGE_BYTES;  // lse, delta floats
  static constexpr int BARS = STATS + STAGES * 2 * BLOCK_Q * 4;
  static constexpr int SMEM_BYTES = BARS + (1 + 2 * STAGES) * 8 + 1024;
  // the partner block's 32 NB f32 a thread x 256 consumer threads land on K/V
  static_assert(32 * NB * 4 * 256 <= RING, "exchange buffer");
};

// consumer thread tc's accumulator into the partner block's exchange buffer
// (float4 i of thread tc at i * 256 + tc: neighbouring threads, neighbouring
// 16 bytes)
template <int N>
__device__ __forceinline__ void send_partial(const float (&acc)[N], uint32_t remote,
                                             int tc) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    st_cluster_v4(remote + (i * 256 + tc) * 16, acc[4 * i], acc[4 * i + 1],
                  acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <int N>
__device__ __forceinline__ void add_partial(float (&acc)[N], const float4* xbuf,
                                            int tc) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 x = xbuf[i * 256 + tc];
    acc[4 * i] += x.x;
    acc[4 * i + 1] += x.y;
    acc[4 * i + 2] += x.z;
    acc[4 * i + 3] += x.w;
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q,   // [B*H, Lq, D], box 64 rows
    const __grid_constant__ CUtensorMap tm_k,   // [B*KVH, Lk, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_v,   // [B*KVH, Lk, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_do,  // [B*H, Lq, D], box 64 rows
    const __grid_constant__ CUtensorMap tm_dk,  // [B*KVH, Lk, D], box 64 rows
    const __grid_constant__ CUtensorMap tm_dv,  // [B*KVH, Lk, D], box 64 rows
    const float* __restrict__ lse,              // [B, H, Lq]
    const float* __restrict__ delta,            // [B, H, Lq]
    int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale,
    int nsplit) {
  using L = Layout<NB>;
  constexpr int KV_TILE = L::KV_TILE, Q_TILE = L::Q_TILE,
                STAGE_BYTES = L::STAGE_BYTES, RING = L::RING, STATS = L::STATS,
                BARS = L::BARS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_tile = smem;
  unsigned char* v_tile = smem + KV_TILE;
  float* lse_s = reinterpret_cast<float*>(smem + STATS);  // [STAGES][64]
  float* del_s = lse_s + STAGES * BLOCK_Q;                 // [STAGES][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  auto q_stage = [&](int s) { return smem + RING + s * STAGE_BYTES; };
  auto do_stage = [&](int s) { return smem + RING + s * STAGE_BYTES + Q_TILE; };

  const int split = blockIdx.x;  // the block's rank in its cluster
  const int bkv = blockIdx.y;    // b * KVH + KV head
  const int rep = H / KVH;
  const int head0 = (bkv / KVH) * H + (bkv % KVH) * rep;  // b * H + first head of the group
  const int k0 = blockIdx.z * BLOCK_K;

  // query rows that see any key of this block: at or after the first key
  // when causal, before the last key + window with a sliding window
  const int k_last = min(k0 + BLOCK_K, Lk) - 1;
  const int row_lo = causal ? k0 : 0;
  const int row_hi = window > 0 ? min(Lq, k_last + window) : Lq;
  const int t_lo = row_lo / BLOCK_Q;
  const int t_hi = row_hi > row_lo ? (row_hi + BLOCK_Q - 1) / BLOCK_Q : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes (statistics)
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensormap(&tm_q);
        prefetch_tensormap(&tm_do);
        mbar_arrive_expect_tx(kv_full, 2 * KV_TILE);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(k_tile + b * KV_BOX, &tm_k, kv_full, b * BOX_COLS, k0, bkv);
          tma_load_3d(v_tile + b * KV_BOX, &tm_v, kv_full, b * BOX_COLS, k0, bkv);
        }
      }
      int it = 0;
      for (int r = split; r < rep; r += nsplit) {
        const int bh = head0 + r;
        for (int t = t_lo; t < t_hi; ++t, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          for (int i = lane; i < BLOCK_Q; i += 32) {
            const int row = t * BLOCK_Q + i;
            const bool in = row < Lq;
            lse_s[s * BLOCK_Q + i] = in ? lse[(size_t)bh * Lq + row] * LOG2E : 0.f;
            del_s[s * BLOCK_Q + i] = in ? delta[(size_t)bh * Lq + row] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[s], 2 * Q_TILE);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              tma_load_3d(q_stage(s) + b * Q_BOX, &tm_q, &full[s], b * BOX_COLS,
                          t * BLOCK_Q, bh);
              tma_load_3d(do_stage(s) + b * Q_BOX, &tm_do, &full[s], b * BOX_COLS,
                          t * BLOCK_Q, bh);
            }
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
    if (nsplit > 1) {  // the consumers' two exchange barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: keys 64cw..
    const int tc = threadIdx.x - 128;      // 0..255
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int kw0 = k0 + cw * 64;
    const int key_a = kw0 + warp * 16 + g, key_b = key_a + 8;
    const float c = sm_scale * LOG2E;
    const unsigned char* k_rows = k_tile + cw * 64 * 128;  // this warpgroup's keys
    const unsigned char* v_rows = v_tile + cw * 64 * 128;

    float dk[32 * NB], dv[32 * NB];
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int r = split; r < rep; r += nsplit) {
      for (int t = t_lo; t < t_hi; ++t, ++it) {
        const int s = it % STAGES;
        const int q0 = t * BLOCK_Q;
        // no key of this warpgroup is seen by a row of this tile
        const bool skip = kw0 >= Lk || (causal && q0 + BLOCK_Q - 1 < kw0) ||
                          (window > 0 && q0 - (kw0 + 63) >= window);
        mbar_wait(&full[s], (it / STAGES) & 1);
        if (!skip) {
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NB; ++kk) {
            wgmma_m64n64k16_ss(st, desc_k_major(k_rows, KV_BOX, kk),
                               desc_k_major(q_stage(s), Q_BOX, kk), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < 4 * NB; ++kk) {
            wgmma_m64n64k16_ss(dpt, desc_k_major(v_rows, KV_BOX, kk),
                               desc_k_major(do_stage(s), Q_BOX, kk), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);

          // P^T into st, dS^T into dpt; column j of the tile is query row q0 + j
          const bool unmasked = kw0 + 63 < Lk && q0 + BLOCK_Q <= Lq &&
                                (!causal || q0 >= kw0 + 63) &&
                                (window <= 0 || q0 + BLOCK_Q - 1 - kw0 < window);
          const float* ls = lse_s + s * BLOCK_Q;
          const float* ds = del_s + s * BLOCK_Q;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(ls + j * 8 + t4 * 2);
            const float2 d2 = *reinterpret_cast<const float2*>(ds + j * 8 + t4 * 2);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float lv = i ? l2.y : l2.x, dlt = i ? d2.y : d2.x;
              float p_a = fast_exp2(fmaf(st[4 * j + i], c, -lv));
              float p_b = fast_exp2(fmaf(st[4 * j + 2 + i], c, -lv));
              if (!unmasked) {
                const int row = q0 + j * 8 + t4 * 2 + i;
                bool ok_a = row < Lq && key_a < Lk, ok_b = row < Lq && key_b < Lk;
                if (causal) {
                  ok_a = ok_a && row >= key_a;
                  ok_b = ok_b && row >= key_b;
                }
                if (window > 0) {
                  ok_a = ok_a && row - key_a < window;
                  ok_b = ok_b && row - key_b < window;
                }
                p_a = ok_a ? p_a : 0.f;
                p_b = ok_b ? p_b : 0.f;
              }
              st[4 * j + i] = p_a;
              st[4 * j + 2 + i] = p_b;
              dpt[4 * j + i] = p_a * (dpt[4 * j + i] - dlt) * sm_scale;
              dpt[4 * j + 2 + i] = p_b * (dpt[4 * j + 2 + i] - dlt) * sm_scale;
            }
          }
          uint32_t pa[4][4], da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            pack_a(pa[kk], st, kk);
            pack_a(da[kk], dpt, kk);
            fence_regs(pa[kk]);
            fence_regs(da[kk]);
          }
          fence_regs(dv);
          fence_regs(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs(dv, pa[kk], desc_mn_major(do_stage(s), Q_BOX, kk), 1);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs(dk, da[kk], desc_mn_major(q_stage(s), Q_BOX, kk), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(da[kk]);
          }
        }
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    // out: NB swizzled [64][64] boxes per warpgroup, in the ring (free now)
    unsigned char* out_dk = smem + RING + cw * Q_TILE;
    unsigned char* out_dv = smem + RING + 2 * Q_TILE + cw * Q_TILE;
    if (nsplit == 1) {
      named_barrier(1, 256);  // both consumer warpgroups are out of the ring
      store_acc_64xD(dk, 1.f, 1.f, out_dk, Q_BOX, &tm_dk, kw0, bkv, 2 + cw);
      store_acc_64xD(dv, 1.f, 1.f, out_dv, Q_BOX, &tm_dv, kw0, bkv, 2 + cw);
    } else {
      // block 0 writes dK, block 1 dV; each sends the other half across
      float4* xbuf = reinterpret_cast<float4*>(smem);  // over K/V, free after A
      __syncwarp();
      cluster_sync();  // A: both blocks are done with K, V and the ring
      const uint32_t remote = map_to_rank(xbuf, split ^ 1);
      // each branch names its array: a runtime choice between two register
      // arrays would put both in local memory
      if (split == 0) {
        send_partial(dv, remote, tc);
      } else {
        send_partial(dk, remote, tc);
      }
      cluster_sync();  // B: the partner's half has landed
      if (split == 0) {
        add_partial(dk, xbuf, tc);
        store_acc_64xD(dk, 1.f, 1.f, out_dk, Q_BOX, &tm_dk, kw0, bkv, 2 + cw);
      } else {
        add_partial(dv, xbuf, tc);
        store_acc_64xD(dv, 1.f, 1.f, out_dv, Q_BOX, &tm_dv, kw0, bkv, 2 + cw);
      }
    }
  }
}

// window <= 0 means no sliding window. Returns the launch's cudaError_t
// (cudaErrorInvalidValue when a TMA map cannot be encoded: base not 16-byte
// aligned).
template <int NB>
int launch_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int B,
                          int H, int KVH, int Lq, int Lk, int causal, int window, int cols,
                          float sm_scale, void* stream) {
  // a map of `cols` columns: a box's columns past them read as zero and
  // are dropped on store
  if (cols < 1 || cols > 64 * NB || cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int SMEM_BYTES = Layout<NB>::SMEM_BYTES;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (!make_map_3d(&tm_q, q, B * H, Lq, BLOCK_Q, cols) ||
      !make_map_3d(&tm_k, k, B * KVH, Lk, BLOCK_K, cols) ||
      !make_map_3d(&tm_v, v, B * KVH, Lk, BLOCK_K, cols) ||
      !make_map_3d(&tm_do, dout, B * H, Lq, BLOCK_Q, cols) ||
      !make_map_3d(&tm_dk, dk, B * KVH, Lk, 64, cols) ||
      !make_map_3d(&tm_dv, dv, B * KVH, Lk, 64, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above the 48 KB default: opt in (cheap to repeat)
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two blocks (a cluster) share a key tile when the group has two heads or
  // more and the grid of one block per key tile would fill at most one wave
  // of the card's SMs: then the heaviest block's chain sets the time, and
  // halving it pays for the exchange (H100, B=2 KVH=8: 1.40x at L=1024, 128
  // blocks; at L=2048, 256 blocks, the unsplit grid was 3.5% faster).
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int key_tiles = (Lk + BLOCK_K - 1) / BLOCK_K;
  const int nsplit = H / KVH >= 2 && key_tiles * B * KVH <= sms ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, B * KVH, key_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_kernel<NB>, tm_q, tm_k, tm_v, tm_do, tm_dk,
                           tm_dv, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), H, KVH, Lq, Lk, causal,
                           window, sm_scale, nsplit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head dim 128
extern "C" int bci_flash_bwd_dkdv_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H, int KVH,
                                       int Lq, int Lk, int causal, int window, int D,
                                       float sm_scale, void* stream) {
  return launch_flash_bwd_dkdv<2>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Lq, Lk,
                                  causal, window, D, sm_scale, stream);
}

// head dim 64
extern "C" int bci_flash_bwd_dkdv_bf16_d64(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int H, int KVH,
                                           int Lq, int Lk, int causal, int window, int D,
                                           float sm_scale, void* stream) {
  return launch_flash_bwd_dkdv<1>(q, k, v, dout, lse, delta, dk, dv, B, H, KVH, Lq, Lk,
                                  causal, window, D, sm_scale, stream);
}

// The CUDA-core kernel of flash_simt.cuh: f32 at head dims 1..256
extern "C" int bci_flash_bwd_dkdv_simt(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B,
                                       int H, int KVH, int Lq, int Lk, int causal,
                                       int window, int D, float sm_scale,
                                       void* stream) {
  return static_cast<int>(flash_simt::dkdv(q, k, v, dout, lse, delta, dk, dv, B, H, KVH,
                                           Lq, Lk, D, causal, window, sm_scale,
                                           static_cast<cudaStream_t>(stream)));
}

// head dim 256 (bf16 at 128 < D <= 256; D a multiple of 8 read in place,
// any other zero-padded to 256 by the wrapper): the kernel of flash_mma.cuh
extern "C" int bci_flash_bwd_dkdv_bf16_d256(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* delta,
                                            void* dk, void* dv, int B, int H, int KVH,
                                            int Lq, int Lk, int causal, int window, int D,
                                            float sm_scale, void* stream) {
  return static_cast<int>(flash_mma::dkdv(q, k, v, dout, lse, delta, dk, dv, B, H, KVH,
                                          Lq, Lk, causal, window, D, sm_scale,
                                          static_cast<cudaStream_t>(stream)));
}
