// VALID 3D convolution of channels-last f32 tensors at block stride 1 or
// 2 for Hopper (sm_90a): an implicit GEMM on the tensor cores (wgmma) in
// 3xTF32. It runs the packed layout's block convolutions
// (ops/packed.py, through ops/s2d_conv.conv3d_cl) where no gradient is
// wanted: the stem, the downsamples, the upsamples and the projection of
// whole-volume correction.
//
// Replaces no Pallas kernel: the JAX package's packed layout leaves these
// convolutions to XLA. cuDNN runs them in f32 on the CUDA cores (FFMA,
// 67 TFLOP/s at best), since one-product TF32 moves a correction by more
// than a Hounsfield unit; 3xTF32 gives f32 accuracy on the tensor cores.
//
//   x   (B, X, Y, Z, Ci)      channels last, Ci a multiple of 4 (the
//                             wrapper pads), 16-byte aligned
//   w   (Co, K)               K-major, K = Kx*Ky*Kz*Ci in the order of the
//                             kernel (Kx, Ky, Kz, Ci, Co): w_big, w_small
//                             its TF32 parts (ops/block_conv.tf32_split)
//   out (B, Xo, Yo, Zo, Co)   f32, Xo = (X - Kx) / s + 1 and so on
//   out[b,ox,oy,oz,:] = sum_{qx,qy,qz,c} x[b, s ox + qx, s oy + qy, s oz + qz, c]
//                                         * w[qx, qy, qz, c, :]
//
// GEMM view: M = B*Xo*Yo*Zo output voxels, N = Co, K. The tile, the ring
// and the 3xTF32 products are B1's (tc_common.cuh, block_conv.cu): a
// 128 x BN output tile per block reducing the whole K, BN = 128 where Co
// fills it (two column tiles at Co = 256), else 64.
//
// The K walk. In channels-last x the Kz z-taps of one (qx, qy) and all
// their channels are one contiguous run of R = Kz*Ci floats, starting at
// the output voxel's base plus (qx*Y + qy)*Z*Ci, at block stride 2 too.
// K is walked as those runs laid end to end: k = p*R + r with p = qx*Ky +
// qy, and a K step is 32 consecutive k (one 128-byte row) in eight 16-byte
// chunks. A chunk never straddles two runs (Ci, so R, is a multiple of 4),
// so a step may end one run and begin the next, and only the last step is
// ragged: the stem (Ci 8, Kz 5, R = 40) fills 1000 of its 1024 K slots,
// where one step per tap would fill 40 of 64. Each loader thread walks its
// own chunk's (qx, qy, r) along K by additions: one division at the start.
//
// What bounds it on the card, per batch of 24 windows of 128^3 (6.6 TFLOP
// of products over the six stages): tensor-core operations, 3 x 6.6 TFLOP
// at 495 TFLOP/s TF32 = 40 ms. An H100 SXM at 700 W takes 86 ms (62-94
// TFLOP/s f32-equivalent by stage; cuDNN's f32 convs 301 ms). The
// projection (6^3 taps, 128 -> 64 channels at block stride 2, K = 27648)
// takes 40 of them at 70 TFLOP/s: at BN = 64 each A element, gathered
// and split in registers, feeds only 64 outputs, and its 216 taps re-read
// x from L2. The upsample to 64^3 (K = 256, 8 K steps) is short enough
// that the prologue and the epilogue's 64 KB of stores a block weigh.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tc_common.cuh"

namespace {

struct Geometry {
  int B, X, Y, Z, Ci;  // x
  int Kx, Ky, Kz, s;   // taps and block stride
  int Xo, Yo, Zo, Co;  // out
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    packed_conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w_big,
                         const float* __restrict__ w_small, float* __restrict__ out, Geometry g) {
  using C = Tile<float, BN>;
  constexpr int A_CHUNKS = kBM * 8 / kThreads;  // 4 rows a thread
  constexpr int B_CHUNKS = BN * 8 / kThreads;   // 4 or 2 rows a thread
  static_assert(BN == 64 || BN == 128, "BN must be 64 or 128");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int64_t M = (int64_t)g.B * g.Xo * g.Yo * g.Zo;
  const int K = g.Kx * g.Ky * g.Kz * g.Ci;
  const int n_tiles = (g.Co + BN - 1) / BN;
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
  int64_t a_base[A_CHUNKS];  // offset of x[b, s ox, s oy, s oz, 0], -1 past M
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int64_t m = m0 + row0 + 32 * i;
    if (m < M) {
      const int64_t oz = m % g.Zo;
      int64_t t = m / g.Zo;
      const int64_t oy = t % g.Yo;
      t /= g.Yo;
      const int64_t ox = t % g.Xo;
      const int64_t b = t / g.Xo;
      a_base[i] = (((b * g.X + g.s * ox) * g.Y + g.s * oy) * g.Z + g.s * oz) * g.Ci;
    } else {
      a_base[i] = -1;
    }
  }
  // this thread's chunk of the K walk: k = 32 step + 4 chunk = p R + r,
  // p = qx Ky + qy
  const int R = g.Kz * g.Ci;
  const int64_t zc = (int64_t)g.Z * g.Ci;
  int k = 4 * chunk;
  int p = k / R;
  int r = k - p * R;
  int qx = p / g.Ky, qy = p - qx * g.Ky;
  const int steps = (K + C::kStep - 1) / C::kStep;

  // called once per step, in order: each call advances the walk a step
  auto load = [&](int step) {
    const uint32_t st = smem_u32(smem + (step % kStages) * C::kStage) + sw;
    const bool k_ok = k < K;
    const int64_t a_off = ((int64_t)qx * g.Y + qy) * zc + r;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const bool ok = k_ok && a_base[i] >= 0;
      cp_async16(st + 32 * i * kRow, ok ? x + a_base[i] + a_off : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int n = n0 + row0 + 32 * i;
      const bool ok = k_ok && n < g.Co;
      const int64_t off = (int64_t)n * K + k;
      cp_async16(st + C::kA + 32 * i * kRow, ok ? w_big + off : w_big, ok);
      cp_async16(st + C::kA + C::kB + 32 * i * kRow, ok ? w_small + off : w_small, ok);
    }
    // the chunk one step on, across as many run ends as it passes
    k += C::kStep;
    r += C::kStep;
    while (r >= R) {
      r -= R;
      if (++qy == g.Ky) qy = 0, ++qx;
    }
  };

  float acc[BN / 2];    // wgmma's accumulator
  float total[BN / 2];  // the partial sums, added on the CUDA cores
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.f;
  // the A fragments (big, small) of two k8 sub-steps, alternating
  uint32_t a_big[2][4] = {}, a_small[2][4] = {};
  // this thread's fragment rows, 16 warp + gr and + 8 of its warpgroup's
  // 64 (gr = lane / 4), at column lane % 4 of each 16-byte chunk
  const int gr = lane >> 2;
  const int a_frag = (wg * 64 + warp * 16 + gr) * kRow + 4 * (lane & 3);

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
    tf32x3_step<BN>(smem + (step % kStages) * C::kStage, a_frag, gr, acc, a_big, a_small);
    if ((step + 1) % kPromote<float> == 0 || step + 1 == steps) promote<BN>(acc, total, a_big, a_small);
  }
  wgmma_wait<0>();
  store_tile<BN>(total, out, m0, n0, M, g.Co, wg, warp, lane);
}

template <int BN>
int launch_tile(const float* x, const float* wb, const float* ws, float* out, const Geometry& g,
                cudaStream_t s) {
  const int64_t M = (int64_t)g.B * g.Xo * g.Yo * g.Zo;
  const int64_t blocks = (M + kBM - 1) / kBM * ((g.Co + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  auto kernel = packed_conv3d_kernel<BN>;
  // the shared-memory opt-in at the first launch on a device only, so that
  // a launch inside a CUDA graph capture makes no call but the launch
  static bool opted_in[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<float, BN>::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, Tile<float, BN>::kSmem, s>>>(x, wb, ws, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns cudaGetLastError() after
// the launch: 0 on success. x (B, X, Y, Z, Ci) channels-last, Ci a multiple
// of 4, at a 16-byte aligned address; w_big / w_small (Co, Kx*Ky*Kz*Ci)
// K-major; out (B, (X-Kx)/s+1, (Y-Ky)/s+1, (Z-Kz)/s+1, Co).
extern "C" int packed_conv3d_f32(const void* x, const void* wb, const void* ws, void* out, int B,
                                 int X, int Y, int Z, int Ci, int Kx, int Ky, int Kz, int stride,
                                 int Co, void* stream) {
  if (B < 1 || Ci < 1 || Ci % 4 != 0 || Co < 1 || stride < 1 || Kx < 1 || Ky < 1 || Kz < 1 ||
      X < Kx || Y < Ky || Z < Kz || (int64_t)Kx * Ky * Kz * Ci + Tile<float, 64>::kStep > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Geometry g{B, X, Y, Z, Ci, Kx, Ky, Kz, stride,
                   (X - Kx) / stride + 1, (Y - Ky) / stride + 1, (Z - Kz) / stride + 1, Co};
  const float* xt = static_cast<const float*>(x);
  const float* wbt = static_cast<const float*>(wb);
  const float* wst = static_cast<const float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Co >= 128) return launch_tile<128>(xt, wbt, wst, o, g, s);
  return launch_tile<64>(xt, wbt, wst, o, g, s);
}
