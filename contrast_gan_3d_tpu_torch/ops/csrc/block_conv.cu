// VALID 3x3x3 block convolution for Hopper (sm_90a): an implicit GEMM on the
// tensor cores (wgmma), 3xTF32 for f32 operands and native bf16 for bf16.
//
// Replaces two Pallas TPU kernels of contrast_gan_3d_tpu/ops/pallas_conv.py,
// with the same function and layout contracts:
// - B1 block_conv3x3x3 (`_kernel`), z-major x:
//     x   (B, Z, X, Y, Ci)   channels last, f32 or bf16
//     w   (3, 3, 3, Ci, Co)  indexed [qx][qy][qz], same dtype as x
//     out (B, Z-2, X-2, Y-2, Co) f32
//     out[b,z,x,y,:] = sum_{qx,qy,qz} x[b, z+qz, x+qx, y+qy, :] @ w[qx,qy,qz]
// - B2 block_conv3x3x3_v2 (`_kernel_v2`): the same contraction with X and Y
//   swapped in memory, x (B, Z, Y, X, Ci) -> out (B, Z-2, Y-2, X-2, Co), w
//   still indexed [qx][qy][qz].
// One body serves both (and B1's input gradient, launched by the wrapper on
// dy padded by 2): the kernel walks x in memory order (Z, D2, D3) and only
// the tap decode depends on which of X and Y is D2 (template kZYX). The
// wrapper hands the weights over K-major per tap, (27, Co, Ci), tap =
// qx*9 + qy*3 + qz, because wgmma reads a tf32 B operand only K-major.
//
// GEMM view: M = B*Zo*D2o*D3o output voxels, N = Co, K = 27*Ci. Each block
// owns a 128 x BN output tile (two warpgroups of 64 rows each) and reduces
// the WHOLE K itself: no atomics, no cross-block sum. Per K step (one tap,
// one 128-byte run of channels: 32 f32 or 64 bf16) all 256 threads
// cp.async the gathered A slab (128 voxels, 16-byte vectors, rows past M
// or channels past Ci zero-filled, so any shape is masked exactly) and the
// weight tile(s) into a ring of 4 shared-memory stages, two stages ahead of
// the products, in the 128-byte-swizzled K-major layout that wgmma's
// descriptors read. The K loop runs channel runs outer and taps inner, so
// the 27 taps re-read overlapping voxels one step apart (from L2, not HBM).
// Offsets are 64-bit: the batch-24 projection input has ~9.7e8 elements.
//
// f32 is 3xTF32 on the tensor cores. TF32 keeps 10 mantissa bits; one TF32
// product misses the port's 1e-4 f32 check (max |err| / max |f64| 2.6e-4
// at K = 27*1024 in the CPU emulation of tests/test_torch_port_tc.py,
// where plain f32 reads 2.6e-7). Each operand is split as big =
// rna_tf32(v), small = rna_tf32(v - big): the weights once per call by the
// wrapper (w_big, w_small), A in registers (cvt.rna.tf32.f32). Three
// products, small*w_big + big*w_small + big*w_big, accumulate in f32; the
// dropped small*small term is ~2^-22 of a product, and the same emulation
// reads 7.0e-8 (the test holds it to 1e-5). The tensor cores' own f32
// accumulation is not round-to-nearest: with one wgmma accumulator over all
// of K = 27*1024 the card read 2.1e-4 at the projection and 1.4e-5 at the
// stem (K = 27*64), growing with K as a truncating sum does. So every
// kPromote K steps (4 for f32, 12 wgmma products a step; 16 for bf16, 4 a
// step) the warpgroup waits for its products and adds the accumulator into
// f32 registers on the CUDA cores (round to nearest), then restarts it.
// bf16 runs one m64nBNk16 product per 16 channels, no split.
//
// What bounds it on the card, at batch 8 over 34^3 blocks (0.928 TFLOP of
// products per stage):
// - tensor-core operations: 3 x 0.928 TFLOP at 495 TFLOP/s TF32 = 5.62 ms
//   (f32), 0.94 ms at 989 TFLOP/s (bf16).
// - shared-memory bandwidth (128 B/clk an SM), for f32: with both operands
//   in shared memory, the twelve m64n128k8 products of a K step read 144 KB
//   (the A slab once per product), over the 1536 tensor-core cycles of the
//   step with the copies in. So f32 takes A from registers: each thread
//   loads its fragment (rows g, g+8; columns t, t+4 of each k8) once per
//   step, splits it, and issues register-A wgmma; shared-memory reads fall
//   to the weight tiles (96 KB a step at the stem). A wgmma in flight reads
//   its A registers, so the fragments alternate between two register sets
//   and each is kept live (`keep`) until the wait that covers its group.
// - L2 at the projection (1024 -> 64): N = 64, so each gathered A element
//   feeds only 64 outputs and the 27 taps re-read the same voxels: about
//   29 GB of A and as much of weight tiles at batch 8. BN = 64 covers all
//   of Co in one column tile, so x is gathered once per tap. The stem
//   (64 -> 1024) takes BN = 128 (8 column tiles): each A slab feeds 128
//   outputs, and the f32 ring fills 192 KB of shared memory.
// wgmma's accumulators stay in registers (BN/2 floats a thread, twice that
// with the f32 partial sums); the epilogue stores each thread's pairs of
// columns straight to global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
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

// D(64 x N, f32 registers) += A(64 x 16, smem) * B(N x 16, smem)^T, bf16
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (BN == 128) wgmma_tf32_n128(d, a, db);
  else wgmma_tf32_n64(d, a, db);
}
template <int BN>
__device__ __forceinline__ void mma_bf16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_bf16_n128(d, da, db);
  else wgmma_bf16_n64(d, da, db);
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

// Spatial dims in memory order: Z, then D2, then D3 (B1: X, Y; B2: Y, X).
// w_big / w_small: (27, Co, Ci) K-major; w_small is unused for bf16.
template <typename T, int BN, bool kZYX>
__global__ void __launch_bounds__(kThreads, 1)
    block_conv3x3x3_kernel(const T* __restrict__ x, const T* __restrict__ w_big,
                           const T* __restrict__ w_small, float* __restrict__ out,
                           int B, int Z, int D2, int D3, int Ci, int Co) {
  using C = Tile<T, BN>;
  constexpr int A_CHUNKS = kBM * 8 / kThreads;  // 4 rows a thread
  constexpr int B_CHUNKS = BN * 8 / kThreads;   // 4 or 2 rows a thread
  static_assert(BN == 64 || BN == 128, "BN must be 64 or 128");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int Zo = Z - 2, D2o = D2 - 2, D3o = D3 - 2;
  const int64_t M = (int64_t)B * Zo * D2o * D3o;
  const int n_tiles = (Co + BN - 1) / BN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31, warp = (tid & 127) >> 5;

  // Loader: this thread copies 16-byte chunk `chunk` of smem rows
  // row0 + 32 i (A voxels, then weight rows); rows 32 apart share the
  // swizzled column (chunk ^ row % 8).
  const int chunk = tid & 7;
  const int row0 = tid >> 3;
  const uint32_t sw = ((chunk ^ (row0 & 7)) << 4) + row0 * kRow;
  int64_t a_base[A_CHUNKS];  // offset of (b, zo, d2, d3, 0), -1 past M
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int64_t m = m0 + row0 + 32 * i;
    if (m < M) {
      const int64_t d3 = m % D3o;
      int64_t t = m / D3o;
      const int64_t d2 = t % D2o;
      t /= D2o;
      const int64_t zo = t % Zo;
      const int64_t b = t / Zo;
      a_base[i] = (((b * Z + zo) * D2 + d2) * D3 + d3) * Ci;
    } else {
      a_base[i] = -1;
    }
  }
  const int c_steps = (Ci + C::kStep - 1) / C::kStep;
  const int steps = 27 * c_steps;

  auto load = [&](int step) {
    const uint32_t st = smem_u32(smem + (step % kStages) * C::kStage) + sw;
    // channel run outer, taps inner: the 27 taps of one run re-read
    // overlapping voxels one K step apart, from L2 rather than HBM
    const int cs = step / 27, tap = step - cs * 27;
    const int c = cs * C::kStep + chunk * C::kChunk;
    const bool c_ok = c < Ci;
    // taps in w's [qx][qy][qz] order; x is offset along (Z, D2, D3)
    const int qx = tap / 9, qy = (tap / 3) % 3, qz = tap % 3;
    const int q2 = kZYX ? qy : qx, q3 = kZYX ? qx : qy;
    const int64_t tap_off = (((int64_t)qz * D2 + q2) * D3 + q3) * Ci + c;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const bool ok = c_ok && a_base[i] >= 0;
      cp_async16(st + 32 * i * kRow, ok ? x + a_base[i] + tap_off : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int n = n0 + row0 + 32 * i;
      const bool ok = c_ok && n < Co;
      const int64_t off = ((int64_t)tap * Co + n) * Ci + c;
      cp_async16(st + C::kA + 32 * i * kRow, ok ? w_big + off : w_big, ok);
      if constexpr (C::k3x)
        cp_async16(st + C::kA + C::kB + 32 * i * kRow, ok ? w_small + off : w_small, ok);
    }
  };

  float acc[BN / 2];    // wgmma's accumulator
  float total[BN / 2];  // the partial sums, added on the CUDA cores
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;
  // f32: the A fragments (big, small) of two k8 sub-steps, alternating
  uint32_t a_big[2][4] = {}, a_small[2][4] = {};
  // this thread's fragment rows, 16 warp + g and + 8 of its warpgroup's 64
  // (g = lane / 4), at column lane % 4 of each 16-byte chunk
  const int g = lane >> 2;
  const int a_frag = (wg * 64 + warp * 16 + g) * kRow + 4 * (lane & 3);

  // stage s lands in slot s % kStages; kStages - 2 stages are in flight
  // ahead of the one being multiplied, and one wgmma group may still read
  // the slot before it
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 3>();
    fence_proxy_async();
    __syncthreads();  // stage `step` is in; every wgmma of step-2 is done
    if (step + kStages - 2 < steps) load(step + kStages - 2);
    cp_async_commit();

    uint8_t* st = smem + (step % kStages) * C::kStage;
    const uint32_t b_u = smem_u32(st) + C::kA;
    if constexpr (C::k3x) {
      // per k8 sub-step: this thread's A elements (rows g, g + 8; columns
      // t, t + 4) from the swizzled slab, split in registers, then three
      // register-A products, one wgmma group; one group may stay in flight
      // while the next sub-step loads and splits
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
    } else {
      const uint32_t a_u = smem_u32(st) + wg * 64 * kRow;  // this warpgroup's rows
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // four k16 sub-steps of 32 bytes
        mma_bf16<BN>(acc, smem_desc(a_u + 32 * k), smem_desc(b_u + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();
    }
    if ((step + 1) % kPromote<T> == 0 || step + 1 == steps) {
      wgmma_wait<0>();
      keep(a_big[0]), keep(a_big[1]), keep(a_small[0]), keep(a_small[1]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        asm volatile("" : "+f"(acc[i])::"memory");  // read only after the wait
        total[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i];

  // accumulator layout of m64nBN: warp w of the warpgroup holds rows
  // 16w + g and 16w + g + 8 (g = lane / 4), columns 8j + 2(lane % 4) + {0,1}
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

template <typename T, int BN, bool kZYX>
int launch_tile(const T* x, const T* wb, const T* ws, float* out, int B, int Z, int D2,
                int D3, int Ci, int Co, int64_t m_tiles, cudaStream_t s) {
  const int64_t blocks = m_tiles * ((Co + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  auto kernel = block_conv3x3x3_kernel<T, BN, kZYX>;
  // above 48 KB, dynamic shared memory needs the opt-in on each device; it
  // is made at the first launch on a device only, so that a launch inside
  // a CUDA graph capture (the trainer's cycles, after an eager first call)
  // makes no call but the launch itself
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<T, BN>::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, Tile<T, BN>::kSmem, s>>>(x, wb, ws, out, B, Z, D2, D3,
                                                                 Ci, Co);
  return (int)cudaGetLastError();
}

// BN 128 when Co fills it (the stem, dx), else 64 (the projection)
inline int tile_n(int Co) { return Co >= 128 ? 128 : 64; }

template <typename T, bool kZYX>
int launch(const void* x, const void* wb, const void* ws, void* out, int B, int Z, int D2,
           int D3, int Ci, int Co, void* stream) {
  if (B < 1 || Z < 3 || D2 < 3 || D3 < 3 || Ci < 1 || Co < 1 ||
      Ci % Tile<T, 64>::kChunk != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)B * (Z - 2) * (D2 - 2) * (D3 - 2);
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* wbt = static_cast<const T*>(wb);
  const T* wst = static_cast<const T*>(ws);
  float* o = static_cast<float*>(out);
  if (tile_n(Co) == 128)
    return launch_tile<T, 128, kZYX>(xt, wbt, wst, o, B, Z, D2, D3, Ci, Co, m_tiles, s);
  return launch_tile<T, 64, kZYX>(xt, wbt, wst, o, B, Z, D2, D3, Ci, Co, m_tiles, s);
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. x channels-last with Ci a multiple of 16 bytes
// (the wrapper pads), at a 16-byte aligned address; w_big / w_small
// (27, Co, Ci) K-major (w_small ignored for bf16). D2, D3 are x's second
// and third spatial dims in memory order: X, Y for B1 (block_conv3x3x3_*),
// Y, X for B2 (*_v2_*).
extern "C" int block_conv3x3x3_f32(const void* x, const void* wb, const void* ws, void* out,
                                   int B, int Z, int D2, int D3, int Ci, int Co,
                                   void* stream) {
  return launch<float, false>(x, wb, ws, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_bf16(const void* x, const void* wb, const void* ws, void* out,
                                    int B, int Z, int D2, int D3, int Ci, int Co,
                                    void* stream) {
  return launch<__nv_bfloat16, false>(x, wb, ws, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_v2_f32(const void* x, const void* wb, const void* ws,
                                      void* out, int B, int Z, int D2, int D3, int Ci,
                                      int Co, void* stream) {
  return launch<float, true>(x, wb, ws, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_v2_bf16(const void* x, const void* wb, const void* ws,
                                       void* out, int B, int Z, int D2, int D3, int Ci,
                                       int Co, void* stream) {
  return launch<__nv_bfloat16, true>(x, wb, ws, out, B, Z, D2, D3, Ci, Co, stream);
}

// The tile a launch with Co output channels takes: writes its N width and
// dynamic shared memory bytes (f32 when is_f32, else bf16).
extern "C" void block_conv3x3x3_tile(int is_f32, int Co, int* bn, int* smem_bytes) {
  *bn = tile_n(Co);
  if (is_f32)
    *smem_bytes = *bn == 128 ? Tile<float, 128>::kSmem : Tile<float, 64>::kSmem;
  else
    *smem_bytes = *bn == 128 ? Tile<__nv_bfloat16, 128>::kSmem : Tile<__nv_bfloat16, 64>::kSmem;
}
