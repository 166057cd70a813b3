// VALID 3x3x3 block convolution for Hopper (sm_90a), as an implicit GEMM.
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
//   still indexed [qx][qy][qz] (the Pallas wrapper's pre-transpose of w is
//   the kernel's tap decode here).
// One body serves both: the kernel walks x in memory order (Z, D2, D3) and
// only the tap decode depends on which of X and Y is D2 (template kZYX).
//
// What bounds it on the card: arithmetic. The generator's two s2d stages at
// batch 8 (128^3 patches, 34^3 blocks -> 32^3 outputs) each do
// 2 * 8 * 32^3 * 27 * 64 * 1024 ~= 0.928 TFLOP (stem 64->1024 channels,
// projection 1024->64) against roughly 80 MB to 1.3 GB of compulsory
// traffic (the large side is the 1 GiB f32 output of the stem / the 1.3 GB
// input of the projection): ~280-3000 FLOP per byte, far above the card's
// ridge point, so operand reuse on chip is what matters.
//
// What this simple design does about it (GEMM view: M = B*Zo*Xo*Yo output
// voxels, N = Co, K = 27*Ci):
// - Each block owns a BM x BN output tile and runs the WHOLE K reduction
//   itself: it loops over the 27 taps and all Ci chunks in-block, so the
//   TPU kernel's sequential k_splits grid axis and its revisited output
//   block disappear — no atomics, no zero-fill pass, no cross-block sum.
// - Per K step it stages a gathered BM x BK slab of A (the BM voxels'
//   channels at this tap, 16 consecutive channels per half-warp) and the
//   BK x BN tile of w[qx,qy,qz] in shared memory; each thread keeps an
//   8 x (BN/16) accumulator tile in registers, so every shared-memory
//   operand feeds 8 or 4 FMAs.
// - The next step's global loads are issued into registers before the
//   current step's FMAs, overlapping memory latency with arithmetic.
// - Arithmetic is FP32 FFMA for both input types (bf16 is widened on
//   load): the f32 result must match a full-f32 reference to 1e-4 of its
//   scale, which TF32 tensor cores cannot promise. Tensor cores
//   (wgmma + TMA) are the next step for speed.
// - Offsets are 64-bit: the batch-24 projection input has ~9.7e8 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;      // output voxels per block
constexpr int kBK = 16;       // channels per K step
constexpr int kThreads = 256; // 16 x 16 thread grid
constexpr int kTM = 8;        // output rows per thread (two groups of 4)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Spatial dims in memory order: Z, then D2, then D3 (B1: X, Y; B2: Y, X).
template <typename T, int BN, bool kZYX>
__global__ void __launch_bounds__(kThreads)
    block_conv3x3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           float* __restrict__ out, int B, int Z, int D2, int D3,
                           int Ci, int Co) {
  constexpr int TN = BN / 16;                      // 4 or 8 columns per thread
  constexpr int A_LOADS = kBM * kBK / kThreads;    // 8
  constexpr int B_LOADS = kBK * BN / kThreads;     // 4 or 8
  constexpr int A_ROW_STEP = kThreads / kBK;       // 16
  constexpr int B_K_STEP = kThreads / BN;          // 4 or 2
  static_assert(kThreads % BN == 0 && BN % 64 == 0, "BN must be 64 or 128");

  __shared__ __align__(16) float As[kBK][kBM + 4];  // A^T: [k][m]
  __shared__ __align__(16) float Bs[kBK][BN];       // [k][n]

  const int Zo = Z - 2, D2o = D2 - 2, D3o = D3 - 2;
  const int64_t M = (int64_t)B * Zo * D2o * D3o;
  const int n_tiles = (Co + BN - 1) / BN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // A loader: this thread always loads channel column a_col of rows
  // a_row0 + i * A_ROW_STEP; a_base is the offset of (b, zo, d2, d3, 0).
  const int a_col = tid % kBK;
  const int a_row0 = tid / kBK;
  int64_t a_base[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int64_t m = m0 + a_row0 + i * A_ROW_STEP;
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
  // B loader: column b_n of rows b_k0 + i * B_K_STEP of the w tile.
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;

  const int c_chunks = (Ci + kBK - 1) / kBK;
  const int steps = 27 * c_chunks;

  float a_reg[A_LOADS];
  float b_reg[B_LOADS];
  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto load = [&](int step) {
    const int tap = step / c_chunks;
    const int c0 = (step - tap * c_chunks) * kBK;
    // taps in w's [qx][qy][qz] order; x is offset along (Z, D2, D3)
    const int qx = tap / 9, qy = (tap / 3) % 3, qz = tap % 3;
    const int q2 = kZYX ? qy : qx, q3 = kZYX ? qx : qy;
    const int64_t tap_off = (((int64_t)qz * D2 + q2) * D3 + q3) * Ci;
    const int c = c0 + a_col;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      a_reg[i] = (a_base[i] >= 0 && c < Ci)
                     ? to_float(x[a_base[i] + tap_off + c])
                     : 0.f;
    const T* wt = w + (int64_t)tap * Ci * Co;
    const int n = n0 + b_n;
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int k = c0 + b_k0 + i * B_K_STEP;
      b_reg[i] = (k < Ci && n < Co) ? to_float(wt[(int64_t)k * Co + n]) : 0.f;
    }
  };

  load(0);
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) As[a_col][a_row0 + i * A_ROW_STEP] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) Bs[b_k0 + i * B_K_STEP][b_n] = b_reg[i];
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], bv[TN];
      // rows g*64 + ty*4 + (0..3), columns g*64 + tx*4 + (0..3)
#pragma unroll
      for (int g = 0; g < kTM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[k][g * 64 + ty * 4]);
        a[g * 4 + 0] = v.x; a[g * 4 + 1] = v.y; a[g * 4 + 2] = v.z; a[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[k][g * 64 + tx * 4]);
        bv[g * 4 + 0] = v.x; bv[g * 4 + 1] = v.y; bv[g * 4 + 2] = v.z; bv[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec_ok = (Co % 4) == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
    float* orow = out + m * Co;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      if (vec_ok && n + 3 < Co) {
        *reinterpret_cast<float4*>(orow + n) = make_float4(
            acc[i][g * 4 + 0], acc[i][g * 4 + 1], acc[i][g * 4 + 2], acc[i][g * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < Co) orow[n + j] = acc[i][g * 4 + j];
      }
    }
  }
}

template <typename T, bool kZYX>
int launch(const void* x, const void* w, void* out, int B, int Z, int D2, int D3,
           int Ci, int Co, void* stream) {
  if (B < 1 || Z < 3 || D2 < 3 || D3 < 3 || Ci < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)B * (Z - 2) * (D2 - 2) * (D3 - 2);
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  const int bn = Co >= 128 ? 128 : 64;
  const int64_t blocks = m_tiles * ((Co + bn - 1) / bn);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  float* o = static_cast<float*>(out);
  if (bn == 128)
    block_conv3x3x3_kernel<T, 128, kZYX><<<(unsigned)blocks, kThreads, 0, s>>>(
        xt, wt, o, B, Z, D2, D3, Ci, Co);
  else
    block_conv3x3x3_kernel<T, 64, kZYX><<<(unsigned)blocks, kThreads, 0, s>>>(
        xt, wt, o, B, Z, D2, D3, Ci, Co);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. D2, D3 are x's second and third spatial dims in
// memory order: X, Y for B1 (block_conv3x3x3_*), Y, X for B2 (*_v2_*).
extern "C" int block_conv3x3x3_f32(const void* x, const void* w, void* out,
                                   int B, int Z, int D2, int D3, int Ci, int Co,
                                   void* stream) {
  return launch<float, false>(x, w, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_bf16(const void* x, const void* w, void* out,
                                    int B, int Z, int D2, int D3, int Ci, int Co,
                                    void* stream) {
  return launch<__nv_bfloat16, false>(x, w, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_v2_f32(const void* x, const void* w, void* out,
                                      int B, int Z, int D2, int D3, int Ci,
                                      int Co, void* stream) {
  return launch<float, true>(x, w, out, B, Z, D2, D3, Ci, Co, stream);
}

extern "C" int block_conv3x3x3_v2_bf16(const void* x, const void* w, void* out,
                                       int B, int Z, int D2, int D3, int Ci,
                                       int Co, void* stream) {
  return launch<__nv_bfloat16, true>(x, w, out, B, Z, D2, D3, Ci, Co, stream);
}
