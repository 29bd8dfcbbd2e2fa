// Hopper (sm_90a) pieces of the port's flash-attention backward (K2 dq, K3
// dk/dv): tensor maps and TMA loads, mbarriers, and warpgroup matrix
// multiplies (`wgmma`) on tiles that TMA wrote with the 128-byte swizzle.
//
// Tile layout. A tile of R rows of D bf16 is stored as D / 64 slabs of R
// rows x 64 columns (128 bytes per row), each slab written by one TMA load
// with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r % 8)) * 16). Slabs are 1024-byte aligned, so the
// swizzle's 8-row atoms line up with the address bits `wgmma` swizzles by.
//   - K-major operand (rows = the M or N dimension, D the reduced one): the
//     descriptor starts at slab k / 4, byte (k % 4) * 32 for k-step k, and
//     steps 1024 bytes per 8 rows.
//   - MN-major operand (rows = the reduced dimension, the 64 columns of a
//     slab the N dimension; wgmma's transpose flag): the descriptor starts
//     at row 16 k of the slab and steps 1024 bytes per 8 rows.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums: types only, the library links no libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the CUDA runtime has loaded (null if
// it has none), so that the library needs no -lcuda at build time.
inline EncodeTiledFn encode_tiled() {
    static const EncodeTiledFn fn = [] {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                        cudaEnableDefault, &status);
#endif
        return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiledFn>(ptr) : nullptr;
    }();
    return fn;
}

// A contiguous (heads, rows, D) bf16 array as a 3-D tensor map whose box is
// one 64-column slab of box_rows rows of one head. Rows at or past `extent`
// (<= rows) read as zeros: TMA fills what lies outside the tensor.
inline bool make_rows_map(CUtensorMap* map, const void* base, int D, int rows, int extent,
                          int heads, int box_rows) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)extent, (cuuint64_t)heads};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
    const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
           == CUDA_SUCCESS;
}

// ----------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// the first 1024-byte aligned address at or after `ptr` in shared memory
__device__ __forceinline__ uint8_t* align_1024(uint8_t* ptr) {
    const uint32_t addr = smem_u32(ptr);
    return ptr + (((addr + 1023u) & ~1023u) - addr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed. A wait of more
// than 2^34 SM clocks (about 9 s) can only be a pipeline that deadlocked:
// it traps, so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    const long long start = clock64();
    uint32_t done = 0;
    do {
        if (clock64() - start > (1ll << 34)) __trap();
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    } while (!done);
}

// barrier among the `count` threads (a multiple of 32) that name barrier `id`
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand starting
// at `ptr`: lbo, sbo the byte offsets between 64-column slabs (read for an
// MN-major operand wider than one slab) and between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* ptr, uint32_t lbo, uint32_t sbo) {
    const uint32_t addr = smem_u32(ptr);
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `pending` committed groups of this warpgroup's wgmma
// are still running (groups complete in the order they were committed)
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 32 float32) = a . b^T (+ d if accumulate): a 64 x 16 and b 32 x 16
// bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 float32) = a . b^T (+ d if accumulate): a 64 x 16 and b 64 x 16
// bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 float32) += a . b: a 64 x 16 bf16 in registers (the fragment
// `acc_to_a_frag` packs), b 16 x 64 bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace sm90
