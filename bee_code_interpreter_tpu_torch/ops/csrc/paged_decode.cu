// Paged decode attention for Hopper (sm_90a): one query token per row, K/V
// read in place from the page pool through the block table, GQA-native,
// split over the sequence (flash-decoding), bf16 or f32 pools.
//
// Head dim 128 with at most 8 query heads per KV head takes the two kernels
// the design below describes; every other head dim 1..256 and any group size
// takes paged_decode_any_kernel (its note further down), through
// bci_paged_decode_any.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/paged_attention.py
// `_kernel` (:47), reached through `paged_decode_attention` (:100). Carried
// over exactly: the block-table entry is clamped to [0, n_pages - 1] so a -1
// sentinel can never address out of bounds (paged_attention.py:151); slots
// at or past the row's length are masked, and positions past the table's
// P * ps slots are never visible; m, l and the accumulator are f32; the
// output is acc / max(l, 1e-30), so a row of length 0 gives 0.
//
// Bound on this card: bytes. Each (token, kv head) costs 2 * 128 * 2 bytes of
// K and V in bf16 and only ~4 * rep * 128 operations, far below the ~295
// operations per byte where the tensor cores would become the limit. So the
// design reads every visible K/V row once and keeps enough bytes in flight:
// - the grid is (split, kv head, row); a split covers a fixed run of whole
//   pages, chosen on the host from the shapes alone (split_pages in
//   ops/paged_attention.py: about two blocks per SM, none shorter than 128
//   tokens, one split when B * kvh fills the card); lengths stay on the
//   device, and a block whose split starts at or past its row's length
//   writes an empty partial (m = -inf, l = 0) and exits;
// - four warps per block, each walking its own 16-token chunks of the split
//   (chunk c goes to warp c % 4) through a two-stage ring of its own, filled
//   asynchronously by one lane and completed on an mbarrier: nothing is
//   widened to f32 in shared memory, and the split's block-table entries are
//   read once, while lengths[b] is in flight;
// - bf16 pools with pages of a multiple of 8 slots (the serving path) take
//   the tensor-core kernel below: TMA boxes of 16 (or 8) slots x 64 columns
//   with the 128-byte swizzle, and warp-level m16n8k16 products with the
//   group's heads padded to 16 rows; f32 pools and other page sizes take
//   the CUDA-core kernel: 1-D bulk copies of page runs, a lane owning 4 of
//   the 128 columns, the rep x 16 partial dot products reduced across the
//   warp by a transposing butterfly (each lane ending with whole scores, not
//   one serial 128-long dot);
// - the online softmax runs in base 2 with the scale folded in, and the four
//   warps' (m, l, acc) are combined in shared memory; with one split the
//   block writes the output, otherwise f32 partials per split, and a second
//   small kernel merges them in the fixed order of split index (empty splits
//   weigh 0, their acc is never read): two calls give the same bits. It is a
//   programmatic dependent launch, so its launch overlaps the split kernel.
//   Both launches are made by the one C entry.
// What is left: on an H100 the split and merge kernels together move about a
// third of HBM's rate at the serving shape (PERF.md); a block's first bytes
// wait for lengths, the table and the first loads in turn, and the partials
// round-trip through device memory rather than a cluster.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 16;    // tokens per ring stage: one warp's unit of work
constexpr int STAGES = 2;    // ring stages per warp
constexpr int MAX_REP = 8;   // query heads per kv head
constexpr int PAGE_CACHE = 128;  // block-table entries a block keeps in shared memory
constexpr int MERGE_SPLITS = 16; // splits a merge thread loads at once
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
// the four warps' partials, combined at the end over the (then idle) ring
constexpr int MERGE_BYTES = WARPS * MAX_REP * (HEAD_DIM + 2) * 4;

template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return WARPS * STAGES * 2 * CHUNK * HEAD_DIM * static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return (ring_bytes<T>() > MERGE_BYTES ? ring_bytes<T>() : MERGE_BYTES) +
         WARPS * STAGES * 8 + 128;
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sums v[i] (i < n) over the warp's 32 lanes, transposing as it goes: at
// the step over lane bit m a lane keeps one half of its values and adds the
// other half of its partner's. After log2(n) steps (n <= 32) lane L holds
// the sum of value L / (32 / n), repeated over its 32 / n neighbours; for
// n = 64, lane L holds values 2L and 2L + 1 in v[0], v[1].
template <int NV, int n, int m>
__device__ __forceinline__ void transpose_reduce(float (&v)[NV], int lane) {
  if constexpr (m >= 1) {
    if constexpr (n >= 2) {
      constexpr int h = n / 2;
      const bool upper = lane & m;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, m);
      }
      transpose_reduce<NV, h, m / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], m);
      transpose_reduce<NV, 1, m / 2>(v, lane);
    }
  }
}

// The block's warps' (m, l, acc) in shared memory, combined: with one
// split, the group's output rows; otherwise the split's f32 partials. One
// output column a thread.
template <typename T>
__device__ __forceinline__ void finish_block(const float* w_acc, const float* w_m,
                                             const float* w_l, int rep, int n_split,
                                             size_t part, T* out_rows, float* m_part,
                                             float* l_part, float* acc_part) {
  const int d = threadIdx.x;
  for (int r = 0; r < rep; ++r) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, w_m[w * MAX_REP + r]);
    float a = 0.f, l = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = w_m[w * MAX_REP + r];
        if (mw != -INFINITY) {  // a warp with no token weighs nothing
          const float f = fast_exp2(mw - M);
          a = fmaf(f, w_acc[(w * MAX_REP + r) * HEAD_DIM + d], a);
          l = fmaf(f, w_l[w * MAX_REP + r], l);
        }
      }
    }
    if (n_split == 1) {
      out_rows[r * HEAD_DIM + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    } else {
      acc_part[(part * rep + r) * HEAD_DIM + d] = a;
      if (d == 0) {
        m_part[part * rep + r] = M;
        l_part[part * rep + r] = l;
      }
    }
  }
}

// The CUDA-core kernel (f32 pools, pages not a multiple of 8 slots). R: query
// heads per kv head padded to a power of two (1, 2, 4 or 8)
template <typename T, int R>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,              // [B, nh, D]
    const T* __restrict__ k_pages,        // [n_pages, kvh, ps, D]
    const T* __restrict__ v_pages,        // [n_pages, kvh, ps, D]
    const int* __restrict__ block_table,  // [B, P]
    const int* __restrict__ lengths,      // [B]
    T* __restrict__ out,                  // [B, nh, D]
    float* __restrict__ m_part,           // [B, kvh, n_split, rep] (n_split > 1)
    float* __restrict__ l_part,           // [B, kvh, n_split, rep]
    float* __restrict__ acc_part,         // [B, kvh, n_split, rep, D]
    int nh, int kvh, int n_pages, int ps, int P, int pps, float sm_scale) {
  constexpr int TILE = CHUNK * HEAD_DIM;    // elements of one tensor in a stage
  constexpr int TS = R <= 4 ? 16 : 8;       // tokens per step: at most 64 scores
  constexpr int N = R * TS;                 // scores of a step
  constexpr int E = N >= 32 ? N / 32 : 1;   // scores a lane holds after the reduce
  constexpr int D = N >= 32 ? 1 : 32 / N;   // lanes holding each score
  constexpr int G = 32 / R;                 // lanes holding one head's scores

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int DATA = ring_bytes<T>() > MERGE_BYTES ? ring_bytes<T>() : MERGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DATA);

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = nh / kvh;
  // the split's first block-table entries, read while lengths[b] is in
  // flight (the loading lane reads any further ones from device memory)
  __shared__ int pages_s[PAGE_CACHE];
  const int* bt = block_table + (size_t)b * P;
  const int p_lo = split * pps, n_cached = min(PAGE_CACHE, min(pps, P - p_lo));
  for (int i = threadIdx.x; i < n_cached; i += THREADS) pages_s[i] = bt[p_lo + i];
  const int len = min(lengths[b], P * ps);
  const int t_lo = split * pps * ps;
  const int t_hi = min(len, min(P, (split + 1) * pps) * ps);
  const size_t part = ((size_t)b * kvh + g) * n_split + split;
  if (n_split > 1 && t_lo >= t_hi) {
    // an empty split: the merge gives it weight 0 and never reads its acc
    if (threadIdx.x < rep) {
      m_part[part * rep + threadIdx.x] = -INFINITY;
      l_part[part * rep + threadIdx.x] = 0.f;
    }
    return;
  }
  const int n_chunks = t_hi > t_lo ? (t_hi - t_lo + CHUNK - 1) / CHUNK : 0;
  grid_dependents_launch();  // the merge (if any) may be scheduled now

  if (threadIdx.x == 0) {
    for (int i = 0; i < WARPS * STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // chunk c's K and V rows into stage st of this warp's ring: one bulk copy
  // per tensor and run of tokens inside one page
  auto load_chunk = [&](int c, int st) {
    const int t0 = t_lo + c * CHUNK, t1 = min(t0 + CHUNK, t_hi);
    T* kd = ring + (warp * STAGES + st) * 2 * TILE;
    T* vd = kd + TILE;
    uint64_t* bar = &full[warp * STAGES + st];
    mbar_arrive_expect_tx(bar, 2u * (t1 - t0) * HEAD_DIM * sizeof(T));
    for (int t = t0; t < t1;) {
      const int lp = t / ps, slot = t - lp * ps;
      const int run = min(t1 - t, ps - slot);
      // the clamp keeps a -1 sentinel inside the pool
      const int entry = lp - p_lo < n_cached ? pages_s[lp - p_lo] : bt[lp];
      const int page = min(max(entry, 0), n_pages - 1);
      const size_t off = (((size_t)page * kvh + g) * ps + slot) * HEAD_DIM;
      const uint32_t bytes = run * HEAD_DIM * sizeof(T);
      bulk_load(kd + (t - t0) * HEAD_DIM, k_pages + off, bytes, bar);
      bulk_load(vd + (t - t0) * HEAD_DIM, v_pages + off, bytes, bar);
      t += run;
    }
  };
  if (lane == 0) {
    for (int i = 0; i < STAGES; ++i) {
      if (warp + i * WARPS < n_chunks) load_chunk(warp + i * WARPS, i);
    }
  }

  // the group's query heads (zero past rep), 4 columns a lane, in base 2
  // with the scale folded in
  const float c = sm_scale * LOG2E;
  float qr[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rep) x = load4(q + ((size_t)b * nh + g * rep + r) * HEAD_DIM + lane * 4);
    qr[r][0] = x.x * c;
    qr[r][1] = x.y * c;
    qr[r][2] = x.z * c;
    qr[r][3] = x.w * c;
  }
  // this lane's running max and sum are those of head (lane / D) * E / 8;
  // its accumulator holds 4 columns of every head
  float m_run = -INFINITY, l_run = 0.f;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int k = 0, ch = warp; ch < n_chunks; ++k, ch += WARPS) {
    const int st = k % STAGES;
    mbar_wait(&full[warp * STAGES + st], (k / STAGES) & 1);
    const T* ks = ring + (warp * STAGES + st) * 2 * TILE;
    const T* vs = ks + TILE;
    const int nv = min(CHUNK, t_hi - (t_lo + ch * CHUNK));  // tokens of the chunk
#pragma unroll
    for (int h = 0; h < CHUNK / TS; ++h) {
      if (TS * h >= nv) break;  // the same for the whole warp
      // partial scores v[r * TS + j] of head r and token TS h + j
      float v[N];
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const int tok = TS * h + j;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tok < nv) kx = load4(ks + tok * HEAD_DIM + lane * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r * TS + j] = fmaf(qr[r][0], kx.x, fmaf(qr[r][1], kx.y,
                         fmaf(qr[r][2], kx.z, qr[r][3] * kx.w)));
        }
      }
      transpose_reduce<N, N, 16>(v, lane);
      // the scores this lane holds: index (lane / D) * E + e, token j
      float s[E];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = ((lane / D) * E + e) % TS;
        s[e] = TS * h + j < nv ? v[e] : -INFINITY;
        mx = fmaxf(mx, s[e]);
      }
#pragma unroll
      for (int o = 1; o < G; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      // token TS h is visible, so the new max is finite
      const float m_new = fmaxf(m_run, mx);
      const float alpha = fast_exp2(m_run - m_new);  // 2^-inf = 0 on the first step
      float p[E];
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        p[e] = fast_exp2(s[e] - m_new);
        sum += p[e];
      }
      if (lane % D) sum = 0.f;  // each score counted once
#pragma unroll
      for (int o = 1; o < G; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      // P V: every lane takes each head's alpha and p from the lane that holds it
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = __shfl_sync(FULL, alpha, r * G);
        acc[r][0] *= a;
        acc[r][1] *= a;
        acc[r][2] *= a;
        acc[r][3] *= a;
      }
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const int tok = TS * h + j;
        float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
        if (tok < nv) vx = load4(vs + tok * HEAD_DIM + lane * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int idx = r * TS + j;
          const float pj = __shfl_sync(FULL, p[idx % E], (idx / E) * D);
          acc[r][0] = fmaf(pj, vx.x, acc[r][0]);
          acc[r][1] = fmaf(pj, vx.y, acc[r][1]);
          acc[r][2] = fmaf(pj, vx.z, acc[r][2]);
          acc[r][3] = fmaf(pj, vx.w, acc[r][3]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0 && ch + STAGES * WARPS < n_chunks) load_chunk(ch + STAGES * WARPS, st);
  }

  // combine the four warps over the ring (every copy has been waited on)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem);  // [WARPS][MAX_REP][D]
  float* w_m = w_acc + WARPS * MAX_REP * HEAD_DIM;  // [WARPS][MAX_REP]
  float* w_l = w_m + WARPS * MAX_REP;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rep) {
      *reinterpret_cast<float4*>(w_acc + (warp * MAX_REP + r) * HEAD_DIM + lane * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  if (lane % G == 0 && lane / G < rep) {
    w_m[warp * MAX_REP + lane / G] = m_run;
    w_l[warp * MAX_REP + lane / G] = l_run;
  }
  __syncthreads();
  finish_block(w_acc, w_m, w_l, rep, n_split, part,
               out + ((size_t)b * nh + g * rep) * HEAD_DIM, m_part, l_part, acc_part);
}

// The bf16 path, for pages of a multiple of 8 slots: the same split, warps
// and ring, but each 16-token chunk arrives by TMA (a 3-D map over the pool
// as [n_pages * kvh, ps, 128], boxes of 64 columns and 16 or 8 slots, the
// 128-byte swizzle, so the fragment reads below are free of bank conflicts)
// and the products run on the tensor cores: warp-level m16n8k16 products
// (mma_m16n8k16) with the group's heads as the 16 rows (zero past rep),
// S = Q K^T from K read by ldmatrix_x4, P rounded to bf16 as the A operand
// of O += P V with V read by ldmatrix_x4_trans. A lane holds its head's (row l / 4) scores of 4 tokens, so
// the softmax reduces over 4 lanes only.
constexpr int MMA_STAGES = 2;                              // ring stages per warp
constexpr int MMA_BOX = CHUNK * 128;                       // [16 slots][64] bf16
constexpr int MMA_STAGE = 4 * MMA_BOX;                     // K and V, two boxes each
constexpr int MMA_RING = WARPS * MMA_STAGES * MMA_STAGE;   // 64 KB: 3 blocks an SM
constexpr int MMA_SMEM = MMA_RING + WARPS * MMA_STAGES * 8 + 1024;
static_assert(MMA_RING >= MERGE_BYTES, "the warps' partials go over the ring");

// byte offset of (slot, column) in a chunk's tensor: two swizzled boxes of
// 64 columns
__device__ __forceinline__ int chunk_offset(int slot, int col) {
  return (col >> 6) * MMA_BOX + swizzled_offset(slot, col & 63);
}

__global__ void __launch_bounds__(THREADS) paged_decode_mma_kernel(
    const __grid_constant__ CUtensorMap tm_k,  // [n_pages * kvh, ps, D]
    const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q,       // [B, nh, D]
    const int* __restrict__ block_table,       // [B, P]
    const int* __restrict__ lengths,           // [B]
    __nv_bfloat16* __restrict__ out,           // [B, nh, D]
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int nh, int kvh, int n_pages, int ps, int P, int pps,
    int box_rows, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + MMA_RING);

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hr = lane >> 2, t4 = lane & 3;  // fragment row (query head) and column pair
  const int rep = nh / kvh;
  __shared__ int pages_s[PAGE_CACHE];
  const int* bt = block_table + (size_t)b * P;
  const int p_lo = split * pps, n_cached = min(PAGE_CACHE, min(pps, P - p_lo));
  for (int i = threadIdx.x; i < n_cached; i += THREADS) pages_s[i] = bt[p_lo + i];
  const int len = min(lengths[b], P * ps);
  const int t_lo = split * pps * ps;
  const int t_hi = min(len, min(P, (split + 1) * pps) * ps);
  const size_t part = ((size_t)b * kvh + g) * n_split + split;
  if (n_split > 1 && t_lo >= t_hi) {
    // an empty split: the merge gives it weight 0 and never reads its acc
    if (threadIdx.x < rep) {
      m_part[part * rep + threadIdx.x] = -INFINITY;
      l_part[part * rep + threadIdx.x] = 0.f;
    }
    return;
  }
  const int n_chunks = t_hi > t_lo ? (t_hi - t_lo + CHUNK - 1) / CHUNK : 0;
  grid_dependents_launch();  // the merge (if any) may be scheduled now

  if (threadIdx.x == 0) {
    prefetch_tensormap(&tm_k);
    prefetch_tensormap(&tm_v);
    for (int i = 0; i < WARPS * MMA_STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto stage = [&](int st) { return smem + (warp * MMA_STAGES + st) * MMA_STAGE; };
  // chunk c's K and V slots into stage st: one box per 64 columns and run of
  // box_rows slots (a chunk lies in one page when box_rows is 16)
  auto load_chunk = [&](int c, int st) {
    const int t0 = t_lo + c * CHUNK, t1 = min(t0 + CHUNK, t_hi);
    const int n_boxes = (t1 - t0 + box_rows - 1) / box_rows;
    unsigned char* kd = stage(st);
    unsigned char* vd = kd + 2 * MMA_BOX;
    uint64_t* bar = &full[warp * MMA_STAGES + st];
    mbar_arrive_expect_tx(bar, n_boxes * 4 * box_rows * 128);
    for (int i = 0; i < n_boxes; ++i) {
      const int t = t0 + i * box_rows, lp = t / ps, slot = t - lp * ps;
      // the clamp keeps a -1 sentinel inside the pool
      const int entry = lp - p_lo < n_cached ? pages_s[lp - p_lo] : bt[lp];
      const int row = min(max(entry, 0), n_pages - 1) * kvh + g;
      const int off = i * box_rows * 128;
      tma_load_3d(kd + off, &tm_k, bar, 0, slot, row);
      tma_load_3d(kd + MMA_BOX + off, &tm_k, bar, BOX_COLS, slot, row);
      tma_load_3d(vd + off, &tm_v, bar, 0, slot, row);
      tma_load_3d(vd + MMA_BOX + off, &tm_v, bar, BOX_COLS, slot, row);
    }
  };
  if (lane == 0) {
    for (int i = 0; i < MMA_STAGES; ++i) {
      if (warp + i * WARPS < n_chunks) load_chunk(warp + i * WARPS, i);
    }
  }

  // Q as A fragments of the 8 k16 steps: row hr (zero past rep), rows 8-15
  // of the tile are zero and are passed as constants
  uint32_t qa[8][2];
  {
    const __nv_bfloat16* qrow = q + ((size_t)b * nh + g * rep + hr) * HEAD_DIM + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      qa[ks][0] = hr < rep ? *reinterpret_cast<const uint32_t*>(qrow + 16 * ks) : 0u;
      qa[ks][1] = hr < rep ? *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8) : 0u;
    }
  }
  const float c = sm_scale * LOG2E;
  // this lane's head hr: running max and sum, and the output columns
  // 8 nt + 2 t4 + {0, 1} in o[nt][0..1] (o[nt][2..3], rows 8-15, stay 0)
  float m_run = -INFINITY, l_run = 0.f;
  float o[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // the ldmatrix row this lane addresses: matrix lane / 8, row lane % 8
  const int mj = lane >> 3, mr = lane & 7;

  for (int k = 0, ch = warp; ch < n_chunks; ++k, ch += WARPS) {
    const int st = k % MMA_STAGES;
    mbar_wait(&full[warp * MMA_STAGES + st], (k / MMA_STAGES) & 1);
    unsigned char* kt = stage(st);
    unsigned char* vt = kt + 2 * MMA_BOX;
    const int nv = min(CHUNK, t_hi - (t_lo + ch * CHUNK));  // tokens of the chunk
    if (nv < CHUNK) {
      // slots past the split's end hold other data (or none was loaded): zero
      // V there, as P = 0 times a stale NaN would not be 0
      for (int i = lane; i < (CHUNK - nv) * 16; i += 32) {
        const int slot = nv + i / 16, piece = i % 16;
        *reinterpret_cast<uint4*>(vt + (piece >> 3) * MMA_BOX + slot * 128 +
                                  (piece & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();  // ordered before any later TMA write of the stage
      __syncwarp();
    }
    // S = Q K^T: tokens 0-7 in s[0], 8-15 in s[1]
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t kb[4];  // b0, b1 of tokens 0-7, then of tokens 8-15
      ldmatrix_x4(kb, kt + chunk_offset((mj >> 1) * 8 + mr, 16 * ks + (mj & 1) * 8));
      mma_m16n8k16(s[0], qa[ks][0], 0u, qa[ks][1], 0u, kb[0], kb[1]);
      mma_m16n8k16(s[1], qa[ks][0], 0u, qa[ks][1], 0u, kb[2], kb[3]);
    }
    // online softmax in base 2 over the chunk's visible tokens; token 0 is
    // visible, so the new max is finite
    float sc[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[nt][i] = nt * 8 + 2 * t4 + i < nv ? s[nt][i] * c : -INFINITY;
        mx = fmaxf(mx, sc[nt][i]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = fast_exp2(m_run - m_new);  // 2^-inf = 0 on the first chunk
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[nt][i] = fast_exp2(sc[nt][i] - m_new);
        sum += sc[nt][i];
      }
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    // O += P V: P (bf16) is the A operand straight from the S layout
    const uint32_t pa0 = pack_bf16(sc[0][0], sc[0][1]);
    const uint32_t pa2 = pack_bf16(sc[1][0], sc[1][1]);
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      uint32_t vb[4];  // b0, b1 of columns 16 n2.., then of 16 n2 + 8..
      ldmatrix_x4_trans(vb, vt + chunk_offset((mj & 1) * 8 + mr, 16 * n2 + (mj >> 1) * 8));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&acc)[4] = o[2 * n2 + h];
        acc[0] *= alpha;
        acc[1] *= alpha;
        mma_m16n8k16(acc, pa0, 0u, pa2, 0u, vb[2 * h], vb[2 * h + 1]);
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0 && ch + MMA_STAGES * WARPS < n_chunks) {
      load_chunk(ch + MMA_STAGES * WARPS, st);
    }
  }

  // combine the four warps over the ring (every load has been waited on)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem);  // [WARPS][MAX_REP][D]
  float* w_m = w_acc + WARPS * MAX_REP * HEAD_DIM;  // [WARPS][MAX_REP]
  float* w_l = w_m + WARPS * MAX_REP;
  if (hr < rep) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      *reinterpret_cast<float2*>(w_acc + (warp * MAX_REP + hr) * HEAD_DIM + nt * 8 +
                                 2 * t4) = make_float2(o[nt][0], o[nt][1]);
    }
    if (t4 == 0) {
      w_m[warp * MAX_REP + hr] = m_run;
      w_l[warp * MAX_REP + hr] = l_run;
    }
  }
  __syncthreads();
  finish_block(w_acc, w_m, w_l, rep, n_split, part,
               out + ((size_t)b * nh + g * rep) * HEAD_DIM, m_part, l_part, acc_part);
}

// out = sum_i 2^(m_i - M) acc_i / max(sum_i 2^(m_i - M) l_i, 1e-30) over the
// splits in index order; one block per (query head of the group, kv head,
// row), one column a thread. A thread loads MERGE_SPLITS splits' (m, l, acc)
// at once (one round trip to memory for up to that many splits) and folds
// them into its running sum, rescaled when the max grows. Launched as a
// programmatic dependent of the split kernel: its blocks may start early and
// wait here until that kernel's writes are complete.
template <typename T>
__global__ void __launch_bounds__(HEAD_DIM) paged_merge_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out, int nh, int kvh,
    int n_split) {
  grid_dependency_wait();
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int rep = nh / kvh;
  const size_t base = ((size_t)b * kvh + g) * n_split;
  float M = -INFINITY, a = 0.f, l = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += MERGE_SPLITS) {
    float ms[MERGE_SPLITS], ls[MERGE_SPLITS], as[MERGE_SPLITS];
#pragma unroll
    for (int i = 0; i < MERGE_SPLITS; ++i) {
      const size_t at = (base + s0 + i) * rep + r;
      const bool in = s0 + i < n_split;
      ms[i] = in ? m_part[at] : -INFINITY;
      ls[i] = in ? l_part[at] : 0.f;
      as[i] = in ? acc_part[at * HEAD_DIM + d] : 0.f;
    }
    float mx = M;
#pragma unroll
    for (int i = 0; i < MERGE_SPLITS; ++i) mx = fmaxf(mx, ms[i]);
    if (mx == -INFINITY) continue;  // no split so far has a visible slot
    const float f = fast_exp2(M - mx);  // 2^-inf = 0 before the first
    a *= f;
    l *= f;
#pragma unroll
    for (int i = 0; i < MERGE_SPLITS; ++i) {
      // an empty split (m = -inf) weighs 0; its acc was never written, so it
      // is selected out, not multiplied
      const float w = ms[i] == -INFINITY ? 0.f : fast_exp2(ms[i] - mx);
      a = fmaf(w, w == 0.f ? 0.f : as[i], a);
      l = fmaf(w, ls[i], l);
    }
    M = mx;
  }
  out[((size_t)b * nh + g * rep + r) * HEAD_DIM + d] = from_f<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int R>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_table, const int* lengths, void* out, void* m_part,
                   void* l_part, void* acc_part, int B, int nh, int kvh, int n_pages,
                   int ps, int P, int pps, float sm_scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, R>;
  // above the 48 KB default: opt in (cheap to repeat)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((P + pps - 1) / pps, kvh, B), THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_table, lengths, static_cast<T*>(out),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), nh, kvh, n_pages, ps, P, pps, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rep(int rep, const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* lengths, void* out,
                       void* m_part, void* l_part, void* acc_part, int B, int nh,
                       int kvh, int n_pages, int ps, int P, int pps, float sm_scale,
                       cudaStream_t stream) {
#define BCI_LAUNCH(R)                                                                \
  launch<T, R>(q, k_pages, v_pages, block_table, lengths, out, m_part, l_part,      \
               acc_part, B, nh, kvh, n_pages, ps, P, pps, sm_scale, stream)
  if (rep <= 1) return BCI_LAUNCH(1);
  if (rep <= 2) return BCI_LAUNCH(2);
  if (rep <= 4) return BCI_LAUNCH(4);
  if (rep <= MAX_REP) return BCI_LAUNCH(8);
#undef BCI_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* lengths, void* out,
                       void* m_part, void* l_part, void* acc_part, int B, int nh,
                       int kvh, int n_pages, int ps, int P, int pps, float sm_scale,
                       cudaStream_t stream) {
  const int box_rows = ps % CHUNK == 0 ? CHUNK : 8;
  CUtensorMap tm_k, tm_v;
  if (nh / kvh > MAX_REP || !make_map_3d(&tm_k, k_pages, n_pages * kvh, ps, box_rows) ||
      !make_map_3d(&tm_v, v_pages, n_pages * kvh, ps, box_rows)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
  if (err != cudaSuccess) return err;
  paged_decode_mma_kernel<<<dim3((P + pps - 1) / pps, kvh, B), THREADS, MMA_SMEM,
                            stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), block_table, lengths,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), nh, kvh, n_pages, ps,
      P, pps, box_rows, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const void* m_part, const void* l_part, const void* acc_part,
                         void* out, int B, int nh, int kvh, int n_split,
                         cudaStream_t stream) {
  // a programmatic dependent launch: the merge's blocks are scheduled while
  // the split kernel runs (it allows them at its start) and wait for its
  // completion inside, so the second launch's latency overlaps the first
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh / kvh, kvh, B);
  cfg.blockDim = dim3(HEAD_DIM);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<T>, static_cast<const float*>(m_part),
                            static_cast<const float*>(l_part),
                            static_cast<const float*>(acc_part), static_cast<T*>(out), nh,
                            kvh, n_split);
}

// The kernel for every head dim and group size the two above do not take
// (dh != 128, or more than MAX_REP query heads per KV head): the query heads
// of a group in blocks of at most ANY_HEADS, each block a split of one row's
// pages (grid (split, kv head x head block, row)), the head blocks of one KV
// head next to each other in the grid, so they run together and read the
// same pages through L2 (JAX pads its group to the sublane tile,
// paged_attention.py:117; here a block takes the next ANY_HEADS heads). A
// lane owns NC consecutive columns (dh <= 32 NC); each warp walks every
// fourth token of the split, reading its K and V rows with plain loads (a row
// of 20 bf16 columns is 40 bytes: no bulk copy or TMA box takes it), and keeps
// the online softmax of each head in f32; the four warps combine in shared
// memory, and with more than one split paged_merge_any_kernel merges the
// f32 partials in split order. Two calls give the same bits.
constexpr int ANY_HEADS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int NC>
__host__ __device__ constexpr int any_smem_bytes() {
  return (WARPS * ANY_HEADS * 32 * NC + 2 * WARPS * ANY_HEADS) * 4;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS) paged_decode_any_kernel(
    const T* __restrict__ q,              // [B, nh, dh]
    const T* __restrict__ k_pages,        // [n_pages, kvh, ps, dh]
    const T* __restrict__ v_pages,        // [n_pages, kvh, ps, dh]
    const int* __restrict__ block_table,  // [B, P]
    const int* __restrict__ lengths,      // [B]
    T* __restrict__ out,                  // [B, nh, dh]
    float* __restrict__ m_part,           // [B, kvh, n_split, rep] (n_split > 1)
    float* __restrict__ l_part,           // [B, kvh, n_split, rep]
    float* __restrict__ acc_part,         // [B, kvh, n_split, rep, dh]
    int nh, int kvh, int n_pages, int ps, int P, int pps, int dh, int n_hc,
    float sm_scale) {
  constexpr int DP = 32 * NC;
  extern __shared__ float w_acc[];  // [WARPS][ANY_HEADS][DP], then m and l
  float* w_m = w_acc + WARPS * ANY_HEADS * DP;  // [WARPS][ANY_HEADS]
  float* w_l = w_m + WARPS * ANY_HEADS;
  const int split = blockIdx.x, g = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int b = blockIdx.z, n_split = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rep = nh / kvh, r0 = hc * ANY_HEADS, nr = min(ANY_HEADS, rep - r0);
  const int* bt = block_table + (size_t)b * P;
  const int len = min(lengths[b], P * ps);
  const int t_lo = split * pps * ps;
  const int t_hi = min(len, min(P, (split + 1) * pps) * ps);
  const size_t part = ((size_t)b * kvh + g) * n_split + split;
  if (n_split > 1 && t_lo >= t_hi) {
    // an empty split: the merge gives it weight 0 and never reads its acc
    if (threadIdx.x < nr) {
      m_part[part * rep + r0 + threadIdx.x] = -INFINITY;
      l_part[part * rep + r0 + threadIdx.x] = 0.f;
    }
    return;
  }
  grid_dependents_launch();  // the merge (if any) may be scheduled now

  // the block's query heads (zero past nr and dh), in base 2 with the
  // scale folded in
  const float c = sm_scale * LOG2E;
  float qr[ANY_HEADS][NC];
#pragma unroll
  for (int r = 0; r < ANY_HEADS; ++r) {
    const T* qrow = q + ((size_t)b * nh + g * rep + r0 + r) * dh;
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int col = lane * NC + e;
      qr[r][e] = r < nr && col < dh ? to_f(qrow[col]) * c : 0.f;
    }
  }
  float m_run[ANY_HEADS], l_run[ANY_HEADS], acc[ANY_HEADS][NC];
#pragma unroll
  for (int r = 0; r < ANY_HEADS; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[r][e] = 0.f;
  }
  for (int t = t_lo + warp; t < t_hi; t += WARPS) {
    const int lp = t / ps, slot = t - lp * ps;
    // the clamp keeps a -1 sentinel inside the pool
    const int page = min(max(bt[lp], 0), n_pages - 1);
    const size_t off = (((size_t)page * kvh + g) * ps + slot) * dh;
    float kx[NC], vx[NC];
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int col = lane * NC + e;
      kx[e] = col < dh ? to_f(k_pages[off + col]) : 0.f;
      vx[e] = col < dh ? to_f(v_pages[off + col]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ANY_HEADS; ++r) {
      if (r >= nr) break;  // the same for the whole warp
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < NC; ++e) s = fmaf(qr[r][e], kx[e], s);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      // the token is visible, so the new max is finite; 2^-inf = 0 first
      const float m_new = fmaxf(m_run[r], s);
      const float alpha = fast_exp2(m_run[r] - m_new);
      const float p = fast_exp2(s - m_new);
      l_run[r] = l_run[r] * alpha + p;
      m_run[r] = m_new;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e] * alpha);
    }
  }

  // combine the four warps; a warp with no token (m = -inf) weighs nothing
#pragma unroll
  for (int r = 0; r < ANY_HEADS; ++r) {
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        w_acc[(warp * ANY_HEADS + r) * DP + lane * NC + e] = acc[r][e];
      }
      if (lane == 0) {
        w_m[warp * ANY_HEADS + r] = m_run[r];
        w_l[warp * ANY_HEADS + r] = l_run[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, w_m[w * ANY_HEADS + r]);
    float a = 0.f, l = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float mw = w_m[w * ANY_HEADS + r];
        if (mw != -INFINITY) {
          const float f = fast_exp2(mw - M);
          a = fmaf(f, w_acc[(w * ANY_HEADS + r) * DP + d], a);
          l = fmaf(f, w_l[w * ANY_HEADS + r], l);
        }
      }
    }
    if (n_split == 1) {
      out[((size_t)b * nh + g * rep + r0 + r) * dh + d] = from_f<T>(a / fmaxf(l, 1e-30f));
    } else {
      acc_part[(part * rep + r0 + r) * dh + d] = a;
      if (d == 0) {
        m_part[part * rep + r0 + r] = M;
        l_part[part * rep + r0 + r] = l;
      }
    }
  }
}

// The merge of paged_decode_any_kernel's partials: paged_merge_kernel's sum
// at any dh, the splits folded one at a time in index order; one block per
// (query head, kv head, row), a thread a column (and more above 256).
template <typename T>
__global__ void __launch_bounds__(256) paged_merge_any_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out, int nh, int kvh, int n_split,
    int dh) {
  grid_dependency_wait();
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = nh / kvh;
  const size_t base = ((size_t)b * kvh + g) * n_split;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float M = -INFINITY, a = 0.f, l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t at = (base + s) * rep + r;
      const float ms = m_part[at];
      if (ms == -INFINITY) continue;  // an empty split: its acc was never written
      if (ms > M) {
        const float f = fast_exp2(M - ms);  // 2^-inf = 0 before the first
        a *= f;
        l *= f;
        M = ms;
      }
      const float w = fast_exp2(ms - M);
      a = fmaf(w, acc_part[at * dh + d], a);
      l = fmaf(w, l_part[at], l);
    }
    out[((size_t)b * nh + g * rep + r) * dh + d] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int NC>
cudaError_t launch_any(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* lengths, void* out,
                       void* m_part, void* l_part, void* acc_part, int B, int nh, int kvh,
                       int n_pages, int ps, int P, int pps, int dh, float sm_scale,
                       cudaStream_t stream) {
  const int n_hc = (nh / kvh + ANY_HEADS - 1) / ANY_HEADS;
  const int n_split = (P + pps - 1) / pps;
  paged_decode_any_kernel<T, NC><<<dim3(n_split, kvh * n_hc, B), THREADS,
                                   any_smem_bytes<NC>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_table, lengths, static_cast<T*>(out),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), nh, kvh, n_pages, ps, P, pps, dh, n_hc, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  // a programmatic dependent launch, as launch_merge's
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nh / kvh, kvh, B);
  const int cols = (dh + 31) / 32 * 32;
  cfg.blockDim = dim3(cols < 256 ? cols : 256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_any_kernel<T>,
                            static_cast<const float*>(m_part),
                            static_cast<const float*>(l_part),
                            static_cast<const float*>(acc_part), static_cast<T*>(out), nh,
                            kvh, n_split, dh);
}

template <typename T>
cudaError_t launch_any_dh(const void* q, const void* k_pages, const void* v_pages,
                          const int* block_table, const int* lengths, void* out,
                          void* m_part, void* l_part, void* acc_part, int B, int nh,
                          int kvh, int n_pages, int ps, int P, int pps, int dh,
                          float sm_scale, cudaStream_t stream) {
#define BCI_LAUNCH(NC)                                                              \
  launch_any<T, NC>(q, k_pages, v_pages, block_table, lengths, out, m_part, l_part, \
                    acc_part, B, nh, kvh, n_pages, ps, P, pps, dh, sm_scale, stream)
  if (dh <= 32) return BCI_LAUNCH(1);
  if (dh <= 64) return BCI_LAUNCH(2);
  if (dh <= 128) return BCI_LAUNCH(4);
  if (dh <= 256) return BCI_LAUNCH(8);
#undef BCI_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pps: pages of the block table per split;
// with more than one split, m_part / l_part ([B, kvh, n_split, rep]) and
// acc_part ([..., 128]) are f32 scratch, and a second launch merges them.
// Returns the launches' cudaError_t.
extern "C" int bci_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const int* block_table,
                                const int* lengths, void* out, void* m_part,
                                void* l_part, void* acc_part, int B, int nh,
                                int kvh, int n_pages, int ps, int P, int pps,
                                float sm_scale, int dtype, void* stream) {
  if (B < 1 || P < 1 || pps < 1 || kvh < 1 || nh % kvh) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = nh / kvh;
  cudaError_t err;
  if (dtype == 1 && ps % 8 == 0) {  // the tensor-core path
    err = launch_mma(q, k_pages, v_pages, block_table, lengths, out, m_part, l_part,
                     acc_part, B, nh, kvh, n_pages, ps, P, pps, sm_scale, s);
  } else if (dtype == 1) {
    err = launch_rep<__nv_bfloat16>(rep, q, k_pages, v_pages, block_table, lengths, out,
                                    m_part, l_part, acc_part, B, nh, kvh, n_pages, ps, P,
                                    pps, sm_scale, s);
  } else {
    err = launch_rep<float>(rep, q, k_pages, v_pages, block_table, lengths, out, m_part,
                            l_part, acc_part, B, nh, kvh, n_pages, ps, P, pps, sm_scale,
                            s);
  }
  const int n_split = (P + pps - 1) / pps;
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  err = dtype == 1 ? launch_merge<__nv_bfloat16>(m_part, l_part, acc_part, out, B, nh,
                                                 kvh, n_split, s)
                   : launch_merge<float>(m_part, l_part, acc_part, out, B, nh, kvh,
                                         n_split, s);
  return static_cast<int>(err);
}

// Every head dim 1 <= dh <= 256 and any group size, through
// paged_decode_any_kernel (and its merge when pps < P): the arguments of
// bci_paged_decode with dh before the scale; acc_part is [..., dh].
extern "C" int bci_paged_decode_any(const void* q, const void* k_pages,
                                    const void* v_pages, const int* block_table,
                                    const int* lengths, void* out, void* m_part,
                                    void* l_part, void* acc_part, int B, int nh,
                                    int kvh, int n_pages, int ps, int P, int pps,
                                    int dh, float sm_scale, int dtype, void* stream) {
  if (B < 1 || P < 1 || pps < 1 || kvh < 1 || nh % kvh || dh < 1 || dh > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? launch_any_dh<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths, out,
                                         m_part, l_part, acc_part, B, nh, kvh, n_pages,
                                         ps, P, pps, dh, sm_scale, s)
          : launch_any_dh<float>(q, k_pages, v_pages, block_table, lengths, out, m_part,
                                 l_part, acc_part, B, nh, kvh, n_pages, ps, P, pps, dh,
                                 sm_scale, s);
  return static_cast<int>(err);
}
