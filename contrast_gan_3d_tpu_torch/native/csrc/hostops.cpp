// Native host-side data ops for the input pipeline.
//
// The reference outsources its host data path to native wheels
// (batchgenerators' C-backed numpy crops, SimpleITK's ITK C++ core —
// SURVEY.md §2). This library is the framework's own native runtime piece:
// zero-copy-ish patch cropping out of memory-mapped (W, H, D, C) int16
// patient arrays (the train-time hot path feeding the TPU) and a vectorized
// trilinear resampler (ostia-patch extraction during labeling). Bound via
// ctypes; built on demand with g++ -O3 (no pybind11 in the image).
//
// Layout contract: volumes are C-contiguous (W, H, D, C) int16 — a crop's
// innermost (z, c) extent is a single contiguous run, so each (x, y) pair
// costs one memcpy.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

extern "C" {

// Copy a (px, py, pz, C) window starting at (sx, sy, sz) — which MAY be
// negative or overhang — from a (W, H, D, C) int16 volume into `out`,
// zero-filling voxels outside the volume. Returns copied voxel count.
long crop_pad_int16(
    const int16_t* __restrict src,
    long W, long H, long D, long C,
    long sx, long sy, long sz,
    long px, long py, long pz,
    int16_t* __restrict out)
{
    std::memset(out, 0, sizeof(int16_t) * px * py * pz * C);

    const long x_lo = std::max(sx, 0L), x_hi = std::min(sx + px, W);
    const long y_lo = std::max(sy, 0L), y_hi = std::min(sy + py, H);
    const long z_lo = std::max(sz, 0L), z_hi = std::min(sz + pz, D);
    if (x_lo >= x_hi || y_lo >= y_hi || z_lo >= z_hi) return 0;

    const long run = (z_hi - z_lo) * C;           // contiguous int16s per (x, y)
    const long src_y_stride = D * C;
    const long src_x_stride = H * D * C;
    const long out_y_stride = pz * C;
    const long out_x_stride = py * pz * C;

    for (long x = x_lo; x < x_hi; ++x) {
        const int16_t* sp = src + x * src_x_stride + y_lo * src_y_stride + z_lo * C;
        int16_t* op = out + (x - sx) * out_x_stride + (y_lo - sy) * out_y_stride
                      + (z_lo - sz) * C;
        for (long y = y_lo; y < y_hi; ++y) {
            std::memcpy(op, sp, sizeof(int16_t) * run);
            sp += src_y_stride;
            op += out_y_stride;
        }
    }
    return (x_hi - x_lo) * (y_hi - y_lo) * (z_hi - z_lo);
}

// Vectorized trilinear interpolation of a (W, H, D) float32 volume at n
// fractional coordinates with the reference fast_trilinear semantics
// (geometry.py:30-58): truncated base, independently clipped +1 neighbor,
// unclamped fraction — EXTRAPOLATES in the border band (the augmentation
// warps below use clamp-to-edge instead, like batchgenerators).
void trilinear_f32(
    const float* __restrict vol,
    long W, long H, long D,
    const float* __restrict xs,
    const float* __restrict ys,
    const float* __restrict zs,
    long n,
    float* __restrict out)
{
    const long sy = D, sx = H * D;
    for (long i = 0; i < n; ++i) {
        float xf = xs[i], yf = ys[i], zf = zs[i];
        // reference fast_trilinear semantics: base index TRUNCATES toward
        // zero (np .astype(int64)), the +1 neighbor is clipped independently
        // of the clipped base, and the fraction is taken against the clamped
        // base — exact even for deep out-of-range coordinates
        const long x0p = (long)xf, y0p = (long)yf, z0p = (long)zf;
        const long x0 = std::min(std::max(x0p, 0L), W - 1);
        const long y0 = std::min(std::max(y0p, 0L), H - 1);
        const long z0 = std::min(std::max(z0p, 0L), D - 1);
        const float fx = xf - x0, fy = yf - y0, fz = zf - z0;
        const long x1 = std::min(std::max(x0p + 1L, 0L), W - 1);
        const long y1 = std::min(std::max(y0p + 1L, 0L), H - 1);
        const long z1 = std::min(std::max(z0p + 1L, 0L), D - 1);

        const float c000 = vol[x0 * sx + y0 * sy + z0];
        const float c100 = vol[x1 * sx + y0 * sy + z0];
        const float c010 = vol[x0 * sx + y1 * sy + z0];
        const float c001 = vol[x0 * sx + y0 * sy + z1];
        const float c110 = vol[x1 * sx + y1 * sy + z0];
        const float c101 = vol[x1 * sx + y0 * sy + z1];
        const float c011 = vol[x0 * sx + y1 * sy + z1];
        const float c111 = vol[x1 * sx + y1 * sy + z1];

        const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
        out[i] = c000 * gx * gy * gz + c100 * fx * gy * gz
               + c010 * gx * fy * gz + c001 * gx * gy * fz
               + c110 * fx * fy * gz + c101 * fx * gy * fz
               + c011 * gx * fy * fz + c111 * fx * fy * fz;
    }
}

// Fused spatial-augmentation warp of one (W, H, D) int16 scan + mask pair:
//   src = A @ (dst - center) + center + amp * elastic(dst)
// where elastic(dst) upsamples a coarse (G, G, G, 3) noise field with the
// half-pixel convention of jax.image.resize(method="linear") — identical to
// the device augmenter. Scan is trilinearly resampled, mask
// nearest-neighbour (clamped edges). This replaces the device-side gather
// (TPUs are very slow at data-dependent gathers: measured 1.4 s for
// 8x128^3 on v5e) — it runs in the async host prefetch pipeline, fully
// overlapped with device compute.
//
// Performance structure (the train-time hot path on small hosts):
// - OpenMP slab-split over x (one patch warp scales across host cores;
//   additionally, whole patches parallelize across prefetch threads since
//   ctypes releases the GIL).
// - The coarse-field interpolation is separable: per-axis (cell, frac)
//   pairs are precomputed once, and per (x, y) the field collapses to G
//   xy-bilerped z-line values, so the inner z loop does 3 lerps instead of
//   a 24-load trilinear gather.
// - Affine coordinates accumulate incrementally along z (one FMA per axis).

long warp_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

void warp_augment_int16(
    const int16_t* __restrict scan,
    const int16_t* __restrict seg,
    long W, long H, long D,
    const float* __restrict affine,   // row-major 3x3
    const float* __restrict coarse,   // (G, G, G, 3) or NULL
    long G,
    const float* __restrict amp,      // (3,) elastic amplitude, voxels
    int16_t* __restrict out_scan,
    int16_t* __restrict out_seg)
{
    const float cx = (W - 1) * 0.5f, cy = (H - 1) * 0.5f, cz = (D - 1) * 0.5f;
    const long sy = D, sx = H * D;

    // per-axis half-pixel coarse-field cells and fractions:
    //   src = clamp((dst + 0.5) * G / dim - 0.5, 0, G - 1)
    std::vector<int> gxs, gys, gzs;
    std::vector<float> axs, ays, azs;
    if (coarse) {
        auto fill = [G](std::vector<int>& cells, std::vector<float>& fracs, long dim) {
            cells.resize(dim);
            fracs.resize(dim);
            const float scale = (float)G / (float)dim;
            for (long i = 0; i < dim; ++i) {
                float f = (i + 0.5f) * scale - 0.5f;
                f = std::min(std::max(f, 0.f), (float)(G - 1));
                long c = std::min(std::max((long)f, 0L), std::max(G - 2, 0L));
                cells[i] = (int)c;
                fracs[i] = f - c;
            }
        };
        fill(gxs, axs, W);
        fill(gys, ays, H);
        fill(gzs, azs, D);
    }

#if defined(__AVX512F__)
    // 16-wide z-line kernel: the gathers dominate (8 trilinear taps + 1
    // nearest mask tap per voxel); vpgatherdd on 32-bit windows at int16
    // element offsets reads {scan[i], scan[i+1]} in one go — capped at
    // element N-2 with a high-half select for i == N-1, so no scratch
    // copies and no out-of-bounds reads. Tails use lane masks.
    const bool use_simd = W * H * D >= 2 && W * H * D < (1L << 31);
#else
    const bool use_simd = false;
#endif

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long x = 0; x < W; ++x) {
        const float rx = x - cx;
        // xy-bilerped coarse z-lines for the current (x, y), per component
        std::vector<float> EzX(coarse ? (size_t)G : 0);
        std::vector<float> EzY(coarse ? (size_t)G : 0);
        std::vector<float> EzZ(coarse ? (size_t)G : 0);
        for (long y = 0; y < H; ++y) {
            const float ry = y - cy;
            // affine coords accumulate along z: p(z) = b + a_col2 * z
            const float bx = affine[0] * rx + affine[1] * ry + affine[2] * (0.f - cz) + cx;
            const float by = affine[3] * rx + affine[4] * ry + affine[5] * (0.f - cz) + cy;
            const float bz = affine[6] * rx + affine[7] * ry + affine[8] * (0.f - cz) + cz;

            if (coarse) {
                const long gx = gxs[x], gy = gys[y];
                const float ax = axs[x], ay = ays[y];
                const long gx1 = std::min(gx + 1, G - 1);
                const long gy1 = std::min(gy + 1, G - 1);
                const float w00 = (1 - ax) * (1 - ay), w10 = ax * (1 - ay);
                const float w01 = (1 - ax) * ay, w11 = ax * ay;
                const long gs = G * 3, gss = G * G * 3;
                const float* r00 = coarse + gx * gss + gy * gs;
                const float* r10 = coarse + gx1 * gss + gy * gs;
                const float* r01 = coarse + gx * gss + gy1 * gs;
                const float* r11 = coarse + gx1 * gss + gy1 * gs;
                for (long gz = 0; gz < G; ++gz) {
                    EzX[gz] = w00 * r00[gz * 3 + 0] + w10 * r10[gz * 3 + 0]
                            + w01 * r01[gz * 3 + 0] + w11 * r11[gz * 3 + 0];
                    EzY[gz] = w00 * r00[gz * 3 + 1] + w10 * r10[gz * 3 + 1]
                            + w01 * r01[gz * 3 + 1] + w11 * r11[gz * 3 + 1];
                    EzZ[gz] = w00 * r00[gz * 3 + 2] + w10 * r10[gz * 3 + 2]
                            + w01 * r01[gz * 3 + 2] + w11 * r11[gz * 3 + 2];
                }
            }

            int16_t* __restrict os = out_scan + x * sx + y * sy;
            int16_t* __restrict og = out_seg + x * sx + y * sy;

#if defined(__AVX512F__)
            if (use_simd) {
                const __m512i iota = _mm512_set_epi32(
                    15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
                const __m512i vzero = _mm512_setzero_si512();
                const __m512i vone = _mm512_set1_epi32(1);
                const __m512 fone = _mm512_set1_ps(1.f);
                const __m512 fhalf = _mm512_set1_ps(0.5f);
                const __m512i vW1 = _mm512_set1_epi32((int)W - 1);
                const __m512i vH1 = _mm512_set1_epi32((int)H - 1);
                const __m512i vD1 = _mm512_set1_epi32((int)D - 1);
                const __m512i vsx = _mm512_set1_epi32((int)sx);
                const __m512i vsy = _mm512_set1_epi32((int)sy);
                const __m512i vcap = _mm512_set1_epi32((int)(W * H * D) - 2);
                const __m512 va2 = _mm512_set1_ps(affine[2]);
                const __m512 va5 = _mm512_set1_ps(affine[5]);
                const __m512 va8 = _mm512_set1_ps(affine[8]);
                const __m512 vbx = _mm512_set1_ps(bx);
                const __m512 vby = _mm512_set1_ps(by);
                const __m512 vbz = _mm512_set1_ps(bz);
                const __m512i vG1 = _mm512_set1_epi32((int)G - 1);
                const __m512 vamp0 = coarse ? _mm512_set1_ps(amp[0]) : fone;
                const __m512 vamp1 = coarse ? _mm512_set1_ps(amp[1]) : fone;
                const __m512 vamp2 = coarse ? _mm512_set1_ps(amp[2]) : fone;

                for (long z = 0; z < D; z += 16) {
                    const int rem = (int)std::min((long)16, D - z);
                    const __mmask16 m =
                        rem == 16 ? (__mmask16)0xFFFF : (__mmask16)((1u << rem) - 1u);

                    const __m512i vzi = _mm512_add_epi32(_mm512_set1_epi32((int)z), iota);
                    const __m512 vz = _mm512_cvtepi32_ps(vzi);
                    __m512 xs = _mm512_fmadd_ps(va2, vz, vbx);
                    __m512 ys = _mm512_fmadd_ps(va5, vz, vby);
                    __m512 zs = _mm512_fmadd_ps(va8, vz, vbz);

                    if (coarse) {
                        const __m512i gz = _mm512_maskz_loadu_epi32(m, gzs.data() + z);
                        const __m512 az = _mm512_maskz_loadu_ps(m, azs.data() + z);
                        const __m512i gz1 =
                            _mm512_min_epi32(_mm512_add_epi32(gz, vone), vG1);
                        const __m512 raz = _mm512_sub_ps(fone, az);
                        __m512 e0 = _mm512_i32gather_ps(gz, EzX.data(), 4);
                        __m512 e1 = _mm512_i32gather_ps(gz1, EzX.data(), 4);
                        xs = _mm512_fmadd_ps(
                            vamp0,
                            _mm512_add_ps(_mm512_mul_ps(e0, raz), _mm512_mul_ps(e1, az)),
                            xs);
                        e0 = _mm512_i32gather_ps(gz, EzY.data(), 4);
                        e1 = _mm512_i32gather_ps(gz1, EzY.data(), 4);
                        ys = _mm512_fmadd_ps(
                            vamp1,
                            _mm512_add_ps(_mm512_mul_ps(e0, raz), _mm512_mul_ps(e1, az)),
                            ys);
                        e0 = _mm512_i32gather_ps(gz, EzZ.data(), 4);
                        e1 = _mm512_i32gather_ps(gz1, EzZ.data(), 4);
                        zs = _mm512_fmadd_ps(
                            vamp2,
                            _mm512_add_ps(_mm512_mul_ps(e0, raz), _mm512_mul_ps(e1, az)),
                            zs);
                    }

                    // floor, clamp, fraction vs clamped base (matches scalar)
                    const __m512i fl_x = _mm512_cvt_roundps_epi32(
                        xs, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    const __m512i fl_y = _mm512_cvt_roundps_epi32(
                        ys, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    const __m512i fl_z = _mm512_cvt_roundps_epi32(
                        zs, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    const __m512i x0 =
                        _mm512_min_epi32(_mm512_max_epi32(fl_x, vzero), vW1);
                    const __m512i y0 =
                        _mm512_min_epi32(_mm512_max_epi32(fl_y, vzero), vH1);
                    const __m512i z0 =
                        _mm512_min_epi32(_mm512_max_epi32(fl_z, vzero), vD1);
                    // fraction clamped to [0,1]: true clamp-to-edge for deep
                    // out-of-bounds coords (batchgenerators border "nearest")
                    const __m512 fx = _mm512_min_ps(fone, _mm512_max_ps(
                        _mm512_setzero_ps(), _mm512_sub_ps(xs, _mm512_cvtepi32_ps(x0))));
                    const __m512 fy = _mm512_min_ps(fone, _mm512_max_ps(
                        _mm512_setzero_ps(), _mm512_sub_ps(ys, _mm512_cvtepi32_ps(y0))));
                    const __m512 fz = _mm512_min_ps(fone, _mm512_max_ps(
                        _mm512_setzero_ps(), _mm512_sub_ps(zs, _mm512_cvtepi32_ps(z0))));
                    const __m512i x1 = _mm512_min_epi32(_mm512_add_epi32(x0, vone), vW1);
                    const __m512i y1 = _mm512_min_epi32(_mm512_add_epi32(y0, vone), vH1);
                    const __m512i z1 = _mm512_min_epi32(_mm512_add_epi32(z0, vone), vD1);
                    const __m512 gx = _mm512_sub_ps(fone, fx);
                    const __m512 gy = _mm512_sub_ps(fone, fy);
                    const __m512 gz_w = _mm512_sub_ps(fone, fz);

                    const __m512i b00 = _mm512_add_epi32(
                        _mm512_mullo_epi32(x0, vsx), _mm512_mullo_epi32(y0, vsy));
                    const __m512i b10 = _mm512_add_epi32(
                        _mm512_mullo_epi32(x1, vsx), _mm512_mullo_epi32(y0, vsy));
                    const __m512i b01 = _mm512_add_epi32(
                        _mm512_mullo_epi32(x0, vsx), _mm512_mullo_epi32(y1, vsy));
                    const __m512i b11 = _mm512_add_epi32(
                        _mm512_mullo_epi32(x1, vsx), _mm512_mullo_epi32(y1, vsy));

                    // capped 32-bit gather of an int16 element: low half at
                    // i <= N-2, high half of the window at N-2 for i == N-1
                    auto tap = [&](const int16_t* base, __m512i idx) -> __m512i {
                        const __m512i capped = _mm512_min_epi32(idx, vcap);
                        const __m512i g = _mm512_mask_i32gather_epi32(
                            vzero, m, capped, (const void*)base, 2);
                        const __mmask16 hi = _mm512_cmpgt_epi32_mask(idx, vcap);
                        const __m512i lo16 =
                            _mm512_srai_epi32(_mm512_slli_epi32(g, 16), 16);
                        const __m512i hi16 = _mm512_srai_epi32(g, 16);
                        return _mm512_mask_blend_epi32(hi, lo16, hi16);
                    };
                    auto tapf = [&](__m512i idx) -> __m512 {
                        return _mm512_cvtepi32_ps(tap(scan, idx));
                    };

                    const __m512 wgg = _mm512_mul_ps(gy, gz_w);
                    const __m512 wfg = _mm512_mul_ps(fy, gz_w);
                    const __m512 wgf = _mm512_mul_ps(gy, fz);
                    const __m512 wff = _mm512_mul_ps(fy, fz);
                    __m512 v = _mm512_mul_ps(
                        tapf(_mm512_add_epi32(b00, z0)), _mm512_mul_ps(gx, wgg));
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b10, z0)), _mm512_mul_ps(fx, wgg), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b01, z0)), _mm512_mul_ps(gx, wfg), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b00, z1)), _mm512_mul_ps(gx, wgf), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b11, z0)), _mm512_mul_ps(fx, wfg), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b10, z1)), _mm512_mul_ps(fx, wgf), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b01, z1)), _mm512_mul_ps(gx, wff), v);
                    v = _mm512_fmadd_ps(
                        tapf(_mm512_add_epi32(b11, z1)), _mm512_mul_ps(fx, wff), v);

                    const __m512i vi = _mm512_cvt_roundps_epi32(
                        _mm512_add_ps(v, fhalf),
                        _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                    _mm512_mask_cvtepi32_storeu_epi16(os + z, m, vi);

                    // nearest-neighbour mask sample: round-half-even (the
                    // device jnp.round), matching the 2D warp's convention
                    const __m512i xn = _mm512_min_epi32(
                        _mm512_max_epi32(
                            _mm512_cvt_roundps_epi32(
                                xs, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC),
                            vzero),
                        vW1);
                    const __m512i yn = _mm512_min_epi32(
                        _mm512_max_epi32(
                            _mm512_cvt_roundps_epi32(
                                ys, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC),
                            vzero),
                        vH1);
                    const __m512i zn = _mm512_min_epi32(
                        _mm512_max_epi32(
                            _mm512_cvt_roundps_epi32(
                                zs, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC),
                            vzero),
                        vD1);
                    const __m512i sidx = _mm512_add_epi32(
                        _mm512_add_epi32(
                            _mm512_mullo_epi32(xn, vsx), _mm512_mullo_epi32(yn, vsy)),
                        zn);
                    _mm512_mask_cvtepi32_storeu_epi16(og + z, m, tap(seg, sidx));
                }
                continue;  // next y
            }
#endif  // __AVX512F__

            for (long z = 0; z < D; ++z) {
                float xs = bx + affine[2] * z;
                float ys = by + affine[5] * z;
                float zs = bz + affine[8] * z;

                if (coarse) {
                    const long gz = gzs[z];
                    const long gz1 = std::min(gz + 1, G - 1);
                    const float az = azs[z];
                    xs += amp[0] * (EzX[gz] * (1 - az) + EzX[gz1] * az);
                    ys += amp[1] * (EzY[gz] * (1 - az) + EzY[gz1] * az);
                    zs += amp[2] * (EzZ[gz] * (1 - az) + EzZ[gz1] * az);
                }

                // trilinear scan sample, clamped (fraction vs clamped floor)
                long x0 = (long)std::floor(xs), y0 = (long)std::floor(ys), z0 = (long)std::floor(zs);
                x0 = std::min(std::max(x0, 0L), W - 1);
                y0 = std::min(std::max(y0, 0L), H - 1);
                z0 = std::min(std::max(z0, 0L), D - 1);
                const float fxw = std::min(1.0f, std::max(0.0f, xs - (float)x0));
                const float fyw = std::min(1.0f, std::max(0.0f, ys - (float)y0));
                const float fzw = std::min(1.0f, std::max(0.0f, zs - (float)z0));
                const long x1 = std::min(x0 + 1L, W - 1);
                const long y1 = std::min(y0 + 1L, H - 1);
                const long z1 = std::min(z0 + 1L, D - 1);
                const float gxw = 1.f - fxw, gyw = 1.f - fyw, gzw = 1.f - fzw;

                const int16_t* p00 = scan + x0 * sx + y0 * sy;
                const int16_t* p10 = scan + x1 * sx + y0 * sy;
                const int16_t* p01 = scan + x0 * sx + y1 * sy;
                const int16_t* p11 = scan + x1 * sx + y1 * sy;
                const float v =
                      p00[z0] * gxw * gyw * gzw
                    + p10[z0] * fxw * gyw * gzw
                    + p01[z0] * gxw * fyw * gzw
                    + p00[z1] * gxw * gyw * fzw
                    + p11[z0] * fxw * fyw * gzw
                    + p10[z1] * fxw * gyw * fzw
                    + p01[z1] * gxw * fyw * fzw
                    + p11[z1] * fxw * fyw * fzw;
                os[z] = (int16_t)std::floor(v + 0.5f);

                // nearest-neighbour mask sample: round-half-even (the
                // device jnp.round), matching the 2D warp's convention
                long xn = (long)std::nearbyintf(xs);
                long yn = (long)std::nearbyintf(ys);
                long zn = (long)std::nearbyintf(zs);
                xn = std::min(std::max(xn, 0L), W - 1);
                yn = std::min(std::max(yn, 0L), H - 1);
                zn = std::min(std::max(zn, 0L), D - 1);
                og[z] = seg[xn * sx + yn * sy + zn];
            }
        }
    }
}

// 2D spatial-augmentation warp of one (W, H) int16 slice + mask pair:
//   src = A @ (dst - center) + center     (A = mirror-scaled rotation, 2x2)
// Bilinear scan sampling and round-half-even nearest mask sampling with
// EXACTLY the device 2D conventions (ops/resample.py bilinear_sample /
// nearest_sample_2d: clamped floor base, +1 neighbor min-clamped from the
// clamped base). Replaces the in-step device augmentation for the conf_2D
// family — the device gather path measured 484 ms per 512x128^2 batch on
// the bench chip, ~10x the augmentation-free 2D train step.
void warp_augment2d_int16(
    const int16_t* __restrict scan,
    const int16_t* __restrict seg,
    long W, long H,
    const float* __restrict affine,   // row-major 2x2
    int16_t* __restrict out_scan,
    int16_t* __restrict out_seg)
{
    const float cx = (W - 1) * 0.5f, cy = (H - 1) * 0.5f;

#if defined(__AVX512F__)
    if (W * H >= 2 && W * H < (1L << 31)) {
        const __m512i iota = _mm512_set_epi32(
            15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
        const __m512i vzero = _mm512_setzero_si512();
        const __m512i vone = _mm512_set1_epi32(1);
        const __m512 fone = _mm512_set1_ps(1.f);
        const __m512i vW1 = _mm512_set1_epi32((int)W - 1);
        const __m512i vH1 = _mm512_set1_epi32((int)H - 1);
        const __m512i vsx = _mm512_set1_epi32((int)H);
        const __m512i vcap = _mm512_set1_epi32((int)(W * H) - 2);
        const __m512 va1 = _mm512_set1_ps(affine[1]);
        const __m512 va3 = _mm512_set1_ps(affine[3]);

        for (long x = 0; x < W; ++x) {
            const float rx = x - cx;
            const float bx = affine[0] * rx + affine[1] * (0.f - cy) + cx;
            const float by = affine[2] * rx + affine[3] * (0.f - cy) + cy;
            const __m512 vbx = _mm512_set1_ps(bx);
            const __m512 vby = _mm512_set1_ps(by);
            int16_t* __restrict os = out_scan + x * H;
            int16_t* __restrict og = out_seg + x * H;

            for (long y = 0; y < H; y += 16) {
                const int rem = (int)std::min((long)16, H - y);
                const __mmask16 m =
                    rem == 16 ? (__mmask16)0xFFFF : (__mmask16)((1u << rem) - 1u);
                const __m512i vyi = _mm512_add_epi32(_mm512_set1_epi32((int)y), iota);
                const __m512 vy = _mm512_cvtepi32_ps(vyi);
                const __m512 xs = _mm512_fmadd_ps(va1, vy, vbx);
                const __m512 ys = _mm512_fmadd_ps(va3, vy, vby);

                // device bilinear_sample: clamped floor base, min-clamped +1
                const __m512i x0 = _mm512_min_epi32(
                    _mm512_max_epi32(
                        _mm512_cvt_roundps_epi32(
                            xs, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC),
                        vzero),
                    vW1);
                const __m512i y0 = _mm512_min_epi32(
                    _mm512_max_epi32(
                        _mm512_cvt_roundps_epi32(
                            ys, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC),
                        vzero),
                    vH1);
                const __m512i x1 = _mm512_min_epi32(_mm512_add_epi32(x0, vone), vW1);
                const __m512i y1 = _mm512_min_epi32(_mm512_add_epi32(y0, vone), vH1);
                const __m512 fx = _mm512_min_ps(fone, _mm512_max_ps(
                    _mm512_setzero_ps(), _mm512_sub_ps(xs, _mm512_cvtepi32_ps(x0))));
                const __m512 fy = _mm512_min_ps(fone, _mm512_max_ps(
                    _mm512_setzero_ps(), _mm512_sub_ps(ys, _mm512_cvtepi32_ps(y0))));
                const __m512 gx = _mm512_sub_ps(fone, fx);
                const __m512 gy = _mm512_sub_ps(fone, fy);

                const __m512i bx0 = _mm512_mullo_epi32(x0, vsx);
                const __m512i bx1 = _mm512_mullo_epi32(x1, vsx);

                auto tap = [&](const int16_t* base, __m512i idx) -> __m512i {
                    const __m512i capped = _mm512_min_epi32(idx, vcap);
                    const __m512i g = _mm512_mask_i32gather_epi32(
                        vzero, m, capped, (const void*)base, 2);
                    const __mmask16 hi = _mm512_cmpgt_epi32_mask(idx, vcap);
                    const __m512i lo16 =
                        _mm512_srai_epi32(_mm512_slli_epi32(g, 16), 16);
                    const __m512i hi16 = _mm512_srai_epi32(g, 16);
                    return _mm512_mask_blend_epi32(hi, lo16, hi16);
                };
                auto tapf = [&](__m512i idx) -> __m512 {
                    return _mm512_cvtepi32_ps(tap(scan, idx));
                };

                __m512 v = _mm512_mul_ps(
                    tapf(_mm512_add_epi32(bx0, y0)), _mm512_mul_ps(gx, gy));
                v = _mm512_fmadd_ps(
                    tapf(_mm512_add_epi32(bx1, y0)), _mm512_mul_ps(fx, gy), v);
                v = _mm512_fmadd_ps(
                    tapf(_mm512_add_epi32(bx0, y1)), _mm512_mul_ps(gx, fy), v);
                v = _mm512_fmadd_ps(
                    tapf(_mm512_add_epi32(bx1, y1)), _mm512_mul_ps(fx, fy), v);

                const __m512i vi = _mm512_cvt_roundps_epi32(
                    _mm512_add_ps(v, _mm512_set1_ps(0.5f)),
                    _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
                _mm512_mask_cvtepi32_storeu_epi16(os + y, m, vi);

                // nearest: round-half-even (device jnp.round), clamped
                const __m512i xn = _mm512_min_epi32(
                    _mm512_max_epi32(
                        _mm512_cvt_roundps_epi32(
                            xs, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC),
                        vzero),
                    vW1);
                const __m512i yn = _mm512_min_epi32(
                    _mm512_max_epi32(
                        _mm512_cvt_roundps_epi32(
                            ys, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC),
                        vzero),
                    vH1);
                const __m512i sidx =
                    _mm512_add_epi32(_mm512_mullo_epi32(xn, vsx), yn);
                _mm512_mask_cvtepi32_storeu_epi16(og + y, m, tap(seg, sidx));
            }
        }
        return;
    }
#endif  // __AVX512F__

    for (long x = 0; x < W; ++x) {
        const float rx = x - cx;
        const float bx = affine[0] * rx + affine[1] * (0.f - cy) + cx;
        const float by = affine[2] * rx + affine[3] * (0.f - cy) + cy;
        int16_t* __restrict os = out_scan + x * H;
        int16_t* __restrict og = out_seg + x * H;
        for (long y = 0; y < H; ++y) {
            const float xs = bx + affine[1] * y;
            const float ys = by + affine[3] * y;
            long x0 = std::min(std::max((long)std::floor(xs), 0L), W - 1);
            long y0 = std::min(std::max((long)std::floor(ys), 0L), H - 1);
            const long x1 = std::min(x0 + 1, W - 1);
            const long y1 = std::min(y0 + 1, H - 1);
            const float fx = std::min(1.0f, std::max(0.0f, xs - (float)x0));
            const float fy = std::min(1.0f, std::max(0.0f, ys - (float)y0));
            const float gx = 1.f - fx, gy = 1.f - fy;
            const float v =
                  scan[x0 * H + y0] * gx * gy
                + scan[x1 * H + y0] * fx * gy
                + scan[x0 * H + y1] * gx * fy
                + scan[x1 * H + y1] * fx * fy;
            os[y] = (int16_t)std::floor(v + 0.5f);
            const long xn = std::min(std::max((long)std::nearbyintf(xs), 0L), W - 1);
            const long yn = std::min(std::max((long)std::nearbyintf(ys), 0L), H - 1);
            og[y] = seg[xn * H + yn];
        }
    }
}

}  // extern "C"
