// Paged decode attention for Hopper (sm_90a): one query token per row, K/V
// read in place from the page pool through the block table, GQA-native.
//
// Replaces the TPU kernel bee_code_interpreter_tpu/ops/paged_attention.py
// `_kernel` (:47), reached through `paged_decode_attention` (:100). Carried
// over exactly: the block-table entry is clamped to [0, n_pages - 1] so a -1
// sentinel can never address out of bounds (paged_attention.py:151); slots
// at or past the row's length are masked; m, l and the accumulator are f32;
// the output is acc / max(l, 1e-30).
//
// Bound on this card: bytes. Each (token, kv head) costs 2 * 128 * 2 bytes of
// K and V in bf16 and only ~4 * rep * 128 operations, far below the ~295
// operations per byte where the tensor cores would become the limit. So the
// design reads every visible K/V row exactly once: one block per (row, kv
// head) stages 32 tokens of K and V in shared memory and all rep = nh / kvh
// query heads of the group use them there; the block walks only the
// ceil(len / 32) chunks the row uses, and never touches pages past the
// length. Loads are 16-byte vectors along dh (a token's head is 256
// contiguous bytes in bf16), all of a thread's loads for a chunk in flight
// at once, and the next chunk's loads overlap the current chunk's math.
// This simple version has no split over the sequence (flash-decoding), so
// at B * kvh = 64 blocks the longest row sets the time and too few bytes
// are in flight to reach the memory rate (see PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int HEAD_DIM = 128;  // one thread per output column
constexpr int CHUNK = 32;      // tokens staged per iteration (one per lane)
constexpr int MAX_REP = 8;     // query heads per kv head
constexpr int ROW = HEAD_DIM + 1;  // f32 smem row stride: conflict-free column reads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q,            // [B, nh, D]
    const T* __restrict__ k_pages,      // [n_pages, kvh, ps, D]
    const T* __restrict__ v_pages,      // [n_pages, kvh, ps, D]
    const int* __restrict__ block_table,  // [B, P]
    const int* __restrict__ lengths,      // [B]
    T* __restrict__ out,                // [B, nh, D]
    int nh, int kvh, int n_pages, int ps, int P, float sm_scale) {
  // a (token, head) row is PER_ROW 16-byte vectors; each thread moves
  // PER_THREAD of them per tensor and chunk
  constexpr int ELEMS = 16 / (int)sizeof(T);
  constexpr int PER_ROW = HEAD_DIM / ELEMS;
  constexpr int PER_THREAD = CHUNK * PER_ROW / THREADS;
  constexpr unsigned FULL = 0xffffffffu;

  __shared__ float Ks[CHUNK * ROW];
  __shared__ float Vs[CHUNK * ROW];
  __shared__ float Qs[MAX_REP * HEAD_DIM];
  __shared__ float Ps[MAX_REP * CHUNK];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rep = nh / kvh;
  // positions past the table's P pages are never visible (as in the
  // TPU kernel, whose grid runs over P pages)
  const int len = min(lengths[b], P * ps);
  const int* bt = block_table + (size_t)b * P;

  for (int i = tid; i < rep * HEAD_DIM; i += THREADS) {
    Qs[i] = to_f(q[((size_t)b * nh + g * rep) * HEAD_DIM + i]);
  }
  if (tid < rep) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.f;

  // K/V of one chunk in registers: all of a thread's 16-byte loads are in
  // flight together, and the next chunk's loads overlap this chunk's math
  uint4 kr[PER_THREAD], vr[PER_THREAD];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = i * THREADS + tid;
      const int s = idx / PER_ROW, u = idx % PER_ROW;
      const int tok = c0 + s;
      kr[i] = make_uint4(0u, 0u, 0u, 0u);
      vr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (tok < len) {
        // the clamp keeps a -1 sentinel inside the pool
        const int page = min(max(bt[tok / ps], 0), n_pages - 1);
        const size_t off = (((size_t)page * kvh + g) * ps + tok % ps) * HEAD_DIM;
        kr[i] = reinterpret_cast<const uint4*>(k_pages + off)[u];
        vr[i] = reinterpret_cast<const uint4*>(v_pages + off)[u];
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = i * THREADS + tid;
      const int s = idx / PER_ROW, u = idx % PER_ROW;
      const T* ke = reinterpret_cast<const T*>(&kr[i]);
      const T* ve = reinterpret_cast<const T*>(&vr[i]);
#pragma unroll
      for (int j = 0; j < ELEMS; ++j) {
        Ks[s * ROW + u * ELEMS + j] = to_f(ke[j]);
        Vs[s * ROW + u * ELEMS + j] = to_f(ve[j]);
      }
    }
  };

  if (len > 0) fetch(0);
  for (int c0 = 0; c0 < len; c0 += CHUNK) {
    __syncthreads();  // the previous chunk is consumed
    stage();  // slots >= len are zeros
    __syncthreads();
    if (c0 + CHUNK < len) fetch(c0 + CHUNK);
    // scores: one thread per (query head, token)
    for (int i = tid; i < rep * CHUNK; i += THREADS) {
      const int r = i / CHUNK, s = i % CHUNK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HEAD_DIM; ++d) dot += Qs[r * HEAD_DIM + d] * Ks[s * ROW + d];
      Ps[r * CHUNK + s] = c0 + s < len ? dot * sm_scale : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per token; the
    // chunk's first token is visible, so the new max is finite
    for (int r = warp; r < rep; r += THREADS / 32) {
      const float sc = Ps[r * CHUNK + lane];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = __expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      Ps[r * CHUNK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = __expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        float a = acc[r] * alpha_s[r];
#pragma unroll 8
        for (int s = 0; s < CHUNK; ++s) a += Ps[r * CHUNK + s] * Vs[s * ROW + tid];
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r < rep) {
      out[((size_t)b * nh + g * rep + r) * HEAD_DIM + tid] =
          from_f<T>(acc[r] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int bci_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const int* block_table,
                                const int* lengths, void* out, int B, int nh,
                                int kvh, int n_pages, int ps, int P,
                                float sm_scale, int dtype, void* stream) {
  dim3 grid(B, kvh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages), block_table, lengths,
        static_cast<__nv_bfloat16*>(out), nh, kvh, n_pages, ps, P, sm_scale);
  } else {
    paged_decode_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), block_table, lengths,
        static_cast<float*>(out), nh, kvh, n_pages, ps, P, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
