// Building blocks of the Hopper (sm_90a) kernels in this directory: TMA
// tensor maps and loads/stores, 1-D bulk copies, mbarriers, wgmma with its shared-memory
// descriptors, setmaxnreg, and the cluster barrier with distributed shared
// memory stores. Header-only; every kernel source that includes it is
// rebuilt when it changes (ops/cuda_build.py hashes csrc/*.cuh).
//
// Layouts, as the kernels use them (bf16, head dim 128):
// - A [rows, 128] tile is loaded by TMA as two boxes of 64 columns (one box
//   row is 128 bytes, the 128-byte swizzle span), each box [rows][64] in
//   shared memory with the 128-byte swizzle: 16-byte chunk c of row r sits at
//   chunk c ^ (r % 8). Every box starts on a 1024-byte boundary.
// - K-major operand (the reduction dimension is the contiguous one: Q and K
//   in Q K^T, K and V in K Q^T / V dO^T): descriptor over `rows` rows of one
//   box, SBO = 1024 bytes (8 rows), LBO unused (1); the k16 step kk of the
//   128-deep reduction is box kk / 4 at +32 bytes * (kk % 4).
// - MN-major operand (the output dimension is the contiguous one: V in P V,
//   dO and Q in P^T dO / dS^T Q): descriptor at reduction row 16 * kk of box
//   0, LBO = the byte distance from box 0 to box 1 (the next 64 output
//   columns), SBO = 1024 bytes (8 reduction rows), transpose bit set.
// - wgmma's f32 accumulator of m64nNk16: thread (warp w of the warpgroup,
//   lane l) holds, for j < N / 8, d[4j], d[4j+1] at row 16w + l/4, columns
//   8j + 2(l%4) + {0, 1}, and d[4j+2], d[4j+3] at row 16w + l/4 + 8. The
//   register A operand of a k16 step kk is that layout's columns 16kk..16kk+15
//   packed to bf16 pairs: a = {d[8kk..8kk+1], d[8kk+2..3], d[8kk+4..5],
//   d[8kk+6..7]}, so an accumulator becomes the next product's A operand in
//   registers (pack_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int HEAD_DIM = 128;
constexpr int BOX_COLS = 64;  // bf16 columns per TMA box: 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any thread (or the TMA unit) uses the barriers
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ----------------------------------------------------------------------- TMA

// box (c0 = column, c1 = row, c2 = head) of a 3-D map into shared memory;
// completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes from global memory into shared memory (1-D bulk
// copy, no tensor map): both addresses 16-byte aligned, `bytes` a multiple
// of 16; completion is counted on `bar` in bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared memory box to global; rows past the map's extent are dropped
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's committed TMA stores are complete (global writes done)
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the issuing thread's committed TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes become visible to the async proxy
// (TMA stores, wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// named barrier over `threads` threads (a multiple of 32); id 0 is
// __syncthreads'
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at a named barrier without waiting for it
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------ programmatic dependent launch

// the next kernel on the stream, if launched with programmatic stream
// serialization, may be scheduled from now on
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the kernels this one depends on have completed and their
// writes are visible
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------- setmaxnreg

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(smem) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

// K-major operand: k16 step kk of a 128-deep reduction over a tile of two
// boxes, each `box_bytes` long
__device__ __forceinline__ uint64_t desc_k_major(const void* tile, int box_bytes,
                                                 int kk) {
  const char* p = static_cast<const char*>(tile) + (kk >> 2) * box_bytes + (kk & 3) * 32;
  return make_desc(p, 16, 1024);
}

// MN-major operand: reduction rows 16kk..16kk+15 of a tile of two boxes
// (output columns 0-63 and 64-127), each `box_bytes` long
__device__ __forceinline__ uint64_t desc_mn_major(const void* tile, int box_bytes,
                                                  int kk) {
  return make_desc(static_cast<const char*>(tile) + kk * 16 * 128, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of these registers across a
// wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D32 HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64 HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_R32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "      \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"

// d (+)= A B, m64n128k16; A and B in shared memory, both K-major;
// scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B, m64n64k16; A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B, m64n128k16; A from registers (pack_a), B in shared memory
// MN-major
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef HOPPER_D8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_R32
#undef HOPPER_R64

// --------------------------------------------------------- mma.sync, ldmatrix

// d += A B, one warp, m16n8k16, bf16 operands (A row-major fragments a0-a3,
// B column fragments b0, b1), f32 accumulator
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of matrix j, r[j] = its row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// the same, transposed: r[j] = column l / 4 of matrix j, rows 2 (l % 4) and
// 2 (l % 4) + 1
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand of k16 step kk from an f32 accumulator (layout above)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// byte offset of element (row, col < 64) in a [rows][64] bf16 box written
// with the 128-byte swizzle
__device__ __forceinline__ int swizzled_offset(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// 2^x, one MUFU instruction; 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A warpgroup's 64 x 128 f32 accumulator, each row times its scale (the
// thread's rows l/4 and l/4 + 8 of its warp's 16), rounded to bf16 into
// `stage` (two swizzled [64][64] boxes, `box_stride` bytes apart, each
// 1024-byte aligned) and stored by TMA at (row0, head) of `map`, whose box is
// 64 x 64. Called by all 128 threads of the warpgroup; `bar_id` is a named
// barrier of its own. With `wait`, the warpgroup's first thread returns once
// the store is complete; without, the caller waits (tma_store_wait_read
// before `stage` is written again, tma_store_wait_all before exit).
__device__ __forceinline__ void store_acc_64x128(const float (&d)[64], float scale_lo,
                                                 float scale_hi, unsigned char* stage,
                                                 int box_stride, const CUtensorMap* map,
                                                 int row0, int head, int bar_id,
                                                 bool wait = true) {
  const int t = threadIdx.x & 127;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2), c = (t & 3) * 2;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    unsigned char* box = stage + (j >> 3) * box_stride;
    const int col = (j & 7) * 8 + c;
    *reinterpret_cast<uint32_t*>(box + swizzled_offset(r, col)) =
        pack_bf16(d[4 * j] * scale_lo, d[4 * j + 1] * scale_lo);
    *reinterpret_cast<uint32_t*>(box + swizzled_offset(r + 8, col)) =
        pack_bf16(d[4 * j + 2] * scale_hi, d[4 * j + 3] * scale_hi);
  }
  fence_proxy_async();
  named_barrier(bar_id, 128);
  if (t == 0) {
    tma_store_3d(map, stage, 0, row0, head);
    tma_store_3d(map, stage + box_stride, BOX_COLS, row0, head);
    tma_store_commit();
    if (wait) tma_store_wait_all();
  }
}

// ------------------------------------------------------------------ cluster

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this block's shared-memory location `p` in block `rank`
// of the cluster
__device__ __forceinline__ uint32_t map_to_rank(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b, float c,
                                              float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// ------------------------------------------------------------------- host

// cuTensorMapEncodeTiled, through the runtime's driver entry point so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// 3-D map over a contiguous bf16 [heads, rows, 128] tensor: boxes of 64
// columns x box_rows rows x 1 head, 128-byte swizzle, out-of-range rows read
// as zero (within the head: the map's rows end at `rows`) and dropped on
// store. Returns false when the driver refuses it.
inline bool make_map_3d(CUtensorMap* map, const void* base, int heads, int rows,
                        int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HEAD_DIM),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {HEAD_DIM * 2ull,
                                 static_cast<cuuint64_t>(rows) * HEAD_DIM * 2ull};
  const cuuint32_t box[3] = {BOX_COLS, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
