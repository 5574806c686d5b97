// Flash-attention forward for Hopper (sm_90a): bf16 inputs, f32 statistics,
// GQA-native, causal or full, optional sliding window, returns out and lse.
// Head dim D = 64 or 128: the kernel is a template over NB = D / 64, the
// 64-column TMA boxes of a Q/K/V/O tile (entry points bci_flash_fwd_bf16_d64
// and bci_flash_fwd_bf16; D = 128 is the design below, D = 64 the same with
// every tile, stage and the O accumulator halved, Q K^T in 4 k16 steps and P V
// at N = 64). Every other head dim JAX's kernel takes runs too: bf16 at D < 128
// that is a multiple of 8 is read in place through maps of D columns (a box's
// columns past D read as zeros and are dropped on store), any other arrives
// zero-padded to 64 or 128 by the wrapper (ops/flash_attention.py: exact, the
// scale stays the true D ** -0.5); bf16 above 128 takes the warp-level
// tensor-core instance of flash_mma.cuh, f32 at every D <= 256 the CUDA-core
// kernel of flash_simt.cuh (entry points below). At ViT-B/16's shape (B = 128,
// H = 12, L = 196, D = 64, non-causal) the work is bound by bytes instead (~155
// MB against 15 GFLOP): the D = 64 instance keeps this design unchanged, so L =
// 196 pads to two 128-row work items and two key tiles, the padded keys masked
// (col < Lk) and the padded rows dropped by the store.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/flash_attention.py
// `_fwd_kernel` (:48), reached through `_flash_fwd` (:170). What it computes
// is the same: per query row, the online softmax over the visible keys, with
// lse = m + log(max(l, 1e-30)) (flash_attention.py:119-121). What it does not
// carry over is the TPU's tiling: the sequential k grid dimension becomes the
// loop inside the block, and there is no padding of L to a block multiple
// (`_compatible_blocks`, `_padded_len`, `_round_up`): the 3-D TMA maps read
// rows past L as zeros within their head, the kernel masks keys >= Lk, and
// the output store drops rows >= Lq.
//
// Bound on this card: operations. Causal prefill at L = 1024, D = 128 does
// 2 * L * L * D multiply-adds per head, far above the ~295 operations per
// byte where an H100 stops being memory bound, so everything serves the
// tensor cores (wgmma, the only route to their full rate):
// - persistent: one block per SM walks work items of 128 query rows of one
//   (batch, head), heaviest first (the last q-tiles, which see the most keys
//   under causal masking), in snake order over rounds of the grid's size, so
//   the next item's Q and K/V loads overlap this item's last tiles and its
//   output store (on an H100: 6-14 % faster than one block per item);
// - three warpgroups: a producer (one thread issuing TMA, registers lowered
//   to 24 by setmaxnreg) and two consumers of 64 rows each (240 registers);
// - Q (128 x 128) is loaded by TMA once an item's last Q K^T is done; K and V
//   tiles of 128 keys go through a two-stage ring of shared memory under
//   full/empty mbarriers, across items (192 KB of shared memory with O's
//   staging tile, one block per SM);
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major, in the 128-byte swizzle TMA wrote; S stays in f32 registers;
// - the online softmax runs in registers, in base 2 with the scale folded in
//   (one FFMA and one MUFU.EX2 per score); P is rounded to bf16 for P V, the
//   row sums use the f32 P;
// - O += P V is wgmma with P as the register A operand (the S accumulator
//   re-packed, no shared-memory round trip) and V read MN-major through the
//   descriptor's transpose bit: no transpose in shared memory;
// - inside a warpgroup, tile j's Q K^T and tile j-1's P V are in flight
//   while tile j's softmax runs (the running output is rescaled once P V is
//   done), and the two consumer warpgroups take turns at issuing their
//   products (named barriers), so one's softmax overlaps the other's wgmmas
//   (on an H100 the turns took 7-8 % off at B=2 L=1024 and B=4 L=2048);
// - only tiles that touch the diagonal, the window edge or the ragged end
//   compute a mask;
// - O goes out through its own staging tile by TMA store (waited on only
//   before the tile is written again), lse by plain stores.
// What is left: the work items are assigned statically (no atomic queue:
// the balance rests on the snake order), both warpgroups walk every key tile
// of an item (one hidden from all of a warpgroup's rows is masked, not
// skipped: the turns need equal counts), and a third ring stage measured no
// gain.

#include <math.h>

#include "flash_mma.cuh"
#include "flash_simt.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK_Q = 128;  // query rows per work item: 2 consumer warpgroups x 64
constexpr int BLOCK_K = 128;  // keys per K/V tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int BOX_BYTES = 128 * 128;  // one [128 rows][64] bf16 box
constexpr int N_BARRIERS = 2 + 4 * STAGES;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory at NB boxes a tile
template <int NB>
struct Layout {
  static constexpr int TILE_BYTES = NB * BOX_BYTES;  // [128][D] bf16
  // Q, the K/V ring, O's staging tile
  static constexpr int SMEM_BYTES = (2 + 2 * STAGES) * TILE_BYTES + N_BARRIERS * 8 + 1024;
};

// The work of one block: 128 query rows of one (batch, head) and the key
// tiles [t_lo, t_hi) any of them can see (none above the causal diagonal,
// none below the sliding window).
struct Block {
  int bh, bkv, q0, t_lo, t_hi;
};

// Work item w, heaviest first: the last q-tiles (the most key tiles under
// causal masking) of every head, then the ones before them.
__device__ __forceinline__ Block block_of(int w, int BH, int n_qt, int H, int KVH, int Lq,
                                          int Lk, int causal, int window) {
  Block b;
  b.bh = w % BH;
  b.bkv = (b.bh / H) * KVH + (b.bh % H) / (H / KVH);
  b.q0 = (n_qt - 1 - w / BH) * BLOCK_Q;
  const int q_last = min(b.q0 + BLOCK_Q, Lq) - 1;
  const int k_hi = causal ? min(Lk, q_last + 1) : Lk;
  const int k_lo = window > 0 ? max(0, b.q0 - window + 1) : 0;
  b.t_lo = k_lo / BLOCK_K;
  b.t_hi = (k_hi + BLOCK_K - 1) / BLOCK_K;
  return b;
}

// The n-th work item of this (persistent) block: rounds of gridDim.x items,
// taken in snake order (block i takes item i of even rounds and item
// gridDim.x - 1 - i of odd ones), so a block that took a heavier item in one
// round takes a lighter one in the next. n_work when there is none left.
__device__ __forceinline__ int work_item(int n, int n_work) {
  const int G = gridDim.x;
  const int w = n * G + ((n & 1) ? G - 1 - blockIdx.x : blockIdx.x);
  return w < n_work ? w : n_work;
}

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile, issued and
// committed (not waited on)
template <int NB>
__device__ __forceinline__ void issue_qk(float (&sc)[64], const unsigned char* q_rows,
                                         const unsigned char* k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    wgmma_m64n128k16_ss(sc, desc_k_major(q_rows, BOX_BYTES, kk),
                        desc_k_major(k_tile, BOX_BYTES, kk), kk > 0);
  }
  wgmma_commit();
}

// O += P V, P from registers, issued and committed (not waited on)
template <int NB>
__device__ __forceinline__ void issue_pv(float (&o)[32 * NB], uint32_t (&pa)[8][4],
                                         const unsigned char* v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs(o, pa[kk], desc_mn_major(v_tile, BOX_BYTES, kk), 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) pack_a(pa[kk], sc, kk);
}

// One online-softmax step on a tile of raw scores in registers (the thread's
// rows row_a = row_b - 8, keys c0 + 8j + 2(lane % 4) + {0, 1}): masks the
// pairs no row may see (only on tiles that touch the diagonal, the window
// edge or the ragged end), updates the running max m and sum l, turns the
// scores into P (f32) and returns the factors alpha that rescale the
// running output. Base 2, the scale folded in: c = scale * log2 e.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int c0, int row_a, int row_b,
                                             int r0, int Lk, int causal, int window,
                                             float c, float& m_a, float& m_b, float& l_a,
                                             float& l_b, float& alpha_a, float& alpha_b) {
  const int t4 = threadIdx.x & 3;
  // every pair of the tile visible to every row of the warpgroup: no mask
  const bool unmasked = c0 + BLOCK_K <= Lk && (!causal || r0 >= c0 + BLOCK_K - 1) &&
                        (window <= 0 || r0 + 63 - c0 < window);
  if (!unmasked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c0 + j * 8 + t4 * 2 + i;
        bool ok_a = col < Lk, ok_b = col < Lk;
        if (causal) {
          ok_a = ok_a && row_a >= col;
          ok_b = ok_b && row_b >= col;
        }
        if (window > 0) {
          ok_a = ok_a && row_a - col < window;
          ok_b = ok_b && row_b - col < window;
        }
        if (!ok_a) sc[4 * j + i] = -INFINITY;
        if (!ok_b) sc[4 * j + 2 + i] = -INFINITY;
      }
    }
  }
  // row maxima (raw scores); the 4 lanes of a row group hold the row
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  // a row with no visible key yet subtracts 0, so 2^-inf gives p = 0
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a * c;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b * c;
  alpha_a = fast_exp2(m_a * c - base_a);
  alpha_b = fast_exp2(m_b * c - base_b);
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], c, -base_a));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], c, -base_a));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], c, -base_b));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], c, -base_b));
    rs_a += sc[4 * j] + sc[4 * j + 1];
    rs_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 1);
  rs_a += __shfl_xor_sync(0xffffffffu, rs_a, 2);
  rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 1);
  rs_b += __shfl_xor_sync(0xffffffffu, rs_b, 2);
  l_a = l_a * alpha_a + rs_a;
  l_b = l_b * alpha_b + rs_b;
  m_a = mn_a;
  m_b = mn_b;
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q,  // [B*H, Lq, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_k,  // [B*KVH, Lk, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_v,  // [B*KVH, Lk, D], box 128 rows
    const __grid_constant__ CUtensorMap tm_o,  // [B*H, Lq, D], box 64 rows
    float* __restrict__ lse,                   // [B, H, Lq]
    int BH, int H, int KVH, int Lq, int Lk, int causal, int window, float sm_scale) {
  constexpr int TILE_BYTES = Layout<NB>::TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_tile = smem;
  unsigned char* o_tile = smem + (1 + 2 * STAGES) * TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (2 + 2 * STAGES) * TILE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* k_empty = bars + 2 + STAGES;
  uint64_t* v_full = bars + 2 + 2 * STAGES;
  uint64_t* v_empty = bars + 2 + 3 * STAGES;
  auto k_tile = [&](int s) { return smem + (1 + s) * TILE_BYTES; };
  auto v_tile = [&](int s) { return smem + (1 + STAGES + s) * TILE_BYTES; };

  const int n_qt = (Lq + BLOCK_Q - 1) / BLOCK_Q;
  const int n_work = n_qt * BH;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int it = 0;
      for (int n = 0, w; (w = work_item(n, n_work)) < n_work; ++n) {
        const Block blk = block_of(w, BH, n_qt, H, KVH, Lq, Lk, causal, window);
        mbar_wait(q_empty, (n & 1) ^ 1);  // the previous block's last Q K^T is done
        mbar_arrive_expect_tx(q_full, TILE_BYTES);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(q_tile + b * BOX_BYTES, &tm_q, q_full, b * BOX_COLS, blk.q0, blk.bh);
        }
        for (int t = blk.t_lo; t < blk.t_hi; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t ph = (it / STAGES) & 1;
          mbar_wait(&k_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&k_full[s], TILE_BYTES);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            tma_load_3d(k_tile(s) + b * BOX_BYTES, &tm_k, &k_full[s], b * BOX_COLS,
                        t * BLOCK_K, blk.bkv);
          }
          mbar_wait(&v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&v_full[s], TILE_BYTES);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            tma_load_3d(v_tile(s) + b * BOX_BYTES, &tm_v, &v_full[s], b * BOX_COLS,
                        t * BLOCK_K, blk.bkv);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_alloc<240>();
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64cw..
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float c = sm_scale * LOG2E;
    unsigned char* q_rows = q_tile + cw * 64 * 128;  // this warpgroup's rows in each box
    unsigned char* o_rows = o_tile + cw * 64 * 128;
    // both warpgroups walk every tile of every block (a tile hidden from all
    // of a warpgroup's rows is masked to P = 0 like any other), so they take
    // turns at issuing their products: while one warpgroup's wgmmas run, the
    // other runs its softmax (named barriers 3 and 4; warpgroup 0 first)
    const int my_turn = 3 + cw, their_turn = 4 - cw;
    if (cw == 1) named_barrier_arrive(3, 256);

    int it = 0;
    for (int n = 0, w; (w = work_item(n, n_work)) < n_work; ++n) {
      const Block blk = block_of(w, BH, n_qt, H, KVH, Lq, Lk, causal, window);
      const int r0 = blk.q0 + cw * 64;
      const int row_a = r0 + warp * 16 + g, row_b = row_a + 8;
      float o[32 * NB];
#pragma unroll
      for (int i = 0; i < 32 * NB; ++i) o[i] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      mbar_wait(q_full, n & 1);

      float sc[64];      // S of the current tile, then its P (f32)
      uint32_t pa[8][4];  // P of the previous tile, bf16, the A operand of P V
      float alpha_a, alpha_b;
      // the first tile: S and the softmax, nothing to overlap with
      int s = it % STAGES;
      uint32_t ph = (it / STAGES) & 1;
      mbar_wait(&k_full[s], ph);
      named_barrier(my_turn, 256);
      issue_qk<NB>(sc, q_rows, k_tile(s));
      named_barrier_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&k_empty[s]);
      softmax_tile(sc, blk.t_lo * BLOCK_K, row_a, row_b, r0, Lk, causal, window, c, m_a,
                   m_b, l_a, l_b, alpha_a, alpha_b);
      pack_p(pa, sc);
      // then, per tile: S = Q K^T of this tile and O += P V of the previous
      // one in flight while this tile's softmax runs
      for (int t = blk.t_lo + 1; t < blk.t_hi; ++t) {
        const int prev = s;
        const uint32_t prev_ph = ph;
        ++it;
        s = it % STAGES;
        ph = (it / STAGES) & 1;
        mbar_wait(&k_full[s], ph);
        mbar_wait(&v_full[prev], prev_ph);
        named_barrier(my_turn, 256);
        issue_qk<NB>(sc, q_rows, k_tile(s));
        issue_pv<NB>(o, pa, v_tile(prev));
        named_barrier_arrive(their_turn, 256);
        wgmma_wait<1>();  // Q K^T, the older group, is done
        fence_regs(sc);
        if (lane == 0) mbar_arrive(&k_empty[s]);
        softmax_tile(sc, t * BLOCK_K, row_a, row_b, r0, Lk, causal, window, c, m_a, m_b,
                     l_a, l_b, alpha_a, alpha_b);
        wgmma_wait<0>();  // P V of the previous tile is done
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
        if (lane == 0) mbar_arrive(&v_empty[prev]);
#pragma unroll
        for (int j = 0; j < 8 * NB; ++j) {
          o[4 * j] *= alpha_a;
          o[4 * j + 1] *= alpha_a;
          o[4 * j + 2] *= alpha_b;
          o[4 * j + 3] *= alpha_b;
        }
        pack_p(pa, sc);
      }
      // every Q K^T of this block is done: the producer may load the next Q
      if (lane == 0) mbar_arrive(q_empty);
      mbar_wait(&v_full[s], ph);
      named_barrier(my_turn, 256);
      issue_pv<NB>(o, pa, v_tile(s));
      named_barrier_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk]);
      if (lane == 0) mbar_arrive(&v_empty[s]);
      ++it;

      if (r0 < Lq) {
        const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
        // the previous block's store has read the staging tile
        if ((threadIdx.x & 127) == 0) tma_store_wait_read();
        named_barrier(1 + cw, 128);
        store_acc_64xD(o, 1.f / lc_a, 1.f / lc_b, o_rows, BOX_BYTES, &tm_o, r0, blk.bh,
                       1 + cw, /*wait=*/false);
        if (t4 == 0) {
          if (row_a < Lq) lse[(size_t)blk.bh * Lq + row_a] = m_a * sm_scale + logf(lc_a);
          if (row_b < Lq) lse[(size_t)blk.bh * Lq + row_b] = m_b * sm_scale + logf(lc_b);
        }
      }
    }
    if (cw == 0) named_barrier(3, 256);  // warpgroup 1's last turn handed back
    if ((threadIdx.x & 127) == 0) tma_store_wait_all();
  }
}

// window <= 0 means no sliding window. Returns the launch's cudaError_t
// (cudaErrorInvalidValue when a TMA map cannot be encoded: base not 16-byte
// aligned).
template <int NB>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                     int B, int H, int KVH, int Lq, int Lk, int causal, int window, int cols,
                     float sm_scale, void* stream) {
  // a map of `cols` columns: a box's columns past them read as zero and
  // are dropped on store
  if (cols < 1 || cols > 64 * NB || cols % 8) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map_3d(&tm_q, q, B * H, Lq, BLOCK_Q, cols) ||
      !make_map_3d(&tm_k, k, B * KVH, Lk, BLOCK_K, cols) ||
      !make_map_3d(&tm_v, v, B * KVH, Lk, BLOCK_K, cols) ||
      !make_map_3d(&tm_o, out, B * H, Lq, 64, cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above the 48 KB default: opt in (cheap to repeat)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<NB>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block per SM (192 KB of shared memory each at D = 128,
  // 96 KB at D = 64), walking the work items
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_work = B * H * ((Lq + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<NB><<<min(n_work, sms), THREADS, Layout<NB>::SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), B * H, H, KVH, Lq, Lk, causal,
      window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// head dim 128
extern "C" int bci_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int H, int KVH,
                                  int Lq, int Lk, int causal, int window, int D,
                                  float sm_scale, void* stream) {
  return launch_flash_fwd<2>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, window, D,
                             sm_scale, stream);
}

// head dim 64
extern "C" int bci_flash_fwd_bf16_d64(const void* q, const void* k, const void* v,
                                      void* out, void* lse, int B, int H, int KVH,
                                      int Lq, int Lk, int causal, int window, int D,
                                      float sm_scale, void* stream) {
  return launch_flash_fwd<1>(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal, window, D,
                             sm_scale, stream);
}

// The CUDA-core kernel of flash_simt.cuh: f32 at head dims 1..256
extern "C" int bci_flash_fwd_simt(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int H, int KVH, int Lq, int Lk,
                                  int causal, int window, int D,
                                  float sm_scale, void* stream) {
  return static_cast<int>(flash_simt::fwd(q, k, v, out, lse, B, H, KVH, Lq, Lk, D, causal,
                                          window, sm_scale,
                                          static_cast<cudaStream_t>(stream)));
}

// head dim 256 (bf16 at 128 < D <= 256; D a multiple of 8 read in place,
// any other zero-padded to 256 by the wrapper): the kernel of flash_mma.cuh
extern "C" int bci_flash_fwd_bf16_d256(const void* q, const void* k, const void* v,
                                       void* out, void* lse, int B, int H, int KVH,
                                       int Lq, int Lk, int causal, int window, int D,
                                       float sm_scale, void* stream) {
  return static_cast<int>(flash_mma::fwd(q, k, v, out, lse, B, H, KVH, Lq, Lk, causal,
                                         window, D, sm_scale,
                                         static_cast<cudaStream_t>(stream)));
}
