// The tensor-core pieces the port's implicit-GEMM convolutions share on
// Hopper (sm_90a): block_conv.cu (B1, B2 and B1's input gradient) and
// packed_conv.cu (the packed layout's f32 block convolutions).
//
// A block owns a 128 x BN output tile (two warpgroups of 64 rows) and
// reduces the whole K itself. Each K step is one 128-byte K-major row per
// output row and per weight column, copied by cp.async into a ring of
// kStages shared-memory stages in the 128-byte-swizzled layout that
// wgmma's descriptors read. f32 runs as 3xTF32: the weights arrive split
// into TF32 big and small parts, A is split in registers, and three
// register-A products accumulate in f32 (tf32x3_step); every kPromote K
// steps the tensor cores' truncating accumulator is added into f32
// registers on the CUDA cores (promote).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // output voxels per block, 64 per warpgroup
constexpr int kRow = 128;      // bytes of one K-major smem row (one K step)
constexpr int kStages = 4;     // cp.async ring depth
// K steps per tensor-core partial sum: f32 (12 wgmma a step), bf16 (4)
template <typename T>
constexpr int kPromote = std::is_same<T, float>::value ? 4 : 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle
// (8-row atoms of 1024 bytes: SBO 1024, LBO unused); addr 1024-aligned for
// the tile, plus 32 bytes per K sub-step inside the atom
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D(64 x N, f32 registers) += A(64 x 8, tf32 registers) * B(N x 8, smem)^T
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (BN == 128) wgmma_tf32_n128(d, a, db);
  else wgmma_tf32_n64(d, a, db);
}

// An A fragment stays live (its registers unshared) until this point: a
// wgmma in flight reads its A registers until a wait covers it.
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

template <typename T, int BN>
struct Tile {
  static constexpr bool k3x = std::is_same<T, float>::value;  // 3xTF32
  static constexpr int kChunk = 16 / sizeof(T);               // elements per 16 B
  static constexpr int kStep = kRow / sizeof(T);              // channels per K step
  static constexpr int kA = kBM * kRow;                       // A slab bytes
  static constexpr int kB = BN * kRow;                        // one weight tile
  static constexpr int kStage = kA + (k3x ? 2 : 1) * kB;
  static constexpr int kSmem = kStages * kStage + 1024;  // + slack to align to 1024
};

// One K step of 3xTF32 products from the ring stage at `st` (A slab, then
// the big and the small weight tiles). Per k8 sub-step: this thread's A
// elements (rows g, g + 8; columns t, t + 4) from the swizzled slab, split
// in registers, then three register-A products, one wgmma group; one group
// may stay in flight while the next sub-step loads and splits. `a_frag`:
// the byte offset of this thread's first fragment element in the slab.
template <int BN>
__device__ __forceinline__ void tf32x3_step(const uint8_t* st, int a_frag, int g, float* acc,
                                            uint32_t (&a_big)[2][4], uint32_t (&a_small)[2][4]) {
  using C = Tile<float, BN>;
  const uint32_t b_u = smem_u32(st) + C::kA;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint8_t* a0 = st + a_frag;
    const int c0 = ((2 * j) ^ g) << 4, c1 = ((2 * j + 1) ^ g) << 4;  // rows g, g + 8 swizzle alike
    const float v[4] = {*reinterpret_cast<const float*>(a0 + c0),
                        *reinterpret_cast<const float*>(a0 + 8 * kRow + c0),
                        *reinterpret_cast<const float*>(a0 + c1),
                        *reinterpret_cast<const float*>(a0 + 8 * kRow + c1)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float big = tf32_rna(v[q]);
      a_big[j & 1][q] = __float_as_uint(big);
      a_small[j & 1][q] = __float_as_uint(tf32_rna(v[q] - big));
    }
    const uint64_t dbb = smem_desc(b_u + 32 * j), dbs = smem_desc(b_u + C::kB + 32 * j);
    wgmma_fence();
    mma_tf32<BN>(acc, a_small[j & 1], dbb);  // small products first
    mma_tf32<BN>(acc, a_big[j & 1], dbs);
    mma_tf32<BN>(acc, a_big[j & 1], dbb);
    wgmma_commit();
    wgmma_wait<1>();
    keep(a_big[(j + 1) & 1]);  // the previous sub-step's group is done
    keep(a_small[(j + 1) & 1]);
  }
}

// Wait for every product, add the accumulator into the f32 partial sums
// (round to nearest on the CUDA cores) and restart it.
template <int BN>
__device__ __forceinline__ void promote(float* acc, float* total, uint32_t (&a_big)[2][4],
                                        uint32_t (&a_small)[2][4]) {
  wgmma_wait<0>();
  keep(a_big[0]), keep(a_big[1]), keep(a_small[0]), keep(a_small[1]);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    asm volatile("" : "+f"(acc[i])::"memory");  // read only after the wait
    total[i] += acc[i];
    acc[i] = 0.f;
  }
}

// Store a warpgroup's m64nBN sums to the row-major (M, Co) output. The
// accumulator layout: warp w of the warpgroup holds rows 16w + g and
// 16w + g + 8 (g = lane / 4), columns 8j + 2(lane % 4) + {0, 1}.
template <int BN>
__device__ __forceinline__ void store_tile(const float* acc, float* __restrict__ out, int64_t m0,
                                           int n0, int64_t M, int Co, int wg, int warp, int lane) {
  const bool pairs = (Co % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t m = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= M) continue;
    float* orow = out + m * Co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs && n + 1 < Co) {
        *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
      } else {
        if (n < Co) orow[n] = v0;
        if (n + 1 < Co) orow[n + 1] = v1;
      }
    }
  }
}

constexpr int kMaxDevices = 64;

}  // namespace
