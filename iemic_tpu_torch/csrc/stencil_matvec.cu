// 27-point x 6-variable stencil matvec for Hopper (sm_90a).
//
//   y[A,k,j,i] = sum_{p<27, B<6} An[p,A,B,k,j,i] * x[B, k+dk_p, j+dj_p, i+di_p]
//
// with x zero outside the grid in j and k, and wrapped in i when
// `periodic` (the reference's `shift`, assemble.F90:142-179).
//
// Replaces the Pallas TPU kernel `_kernel` / `apply_stencil_prepared` of
// iemic_tpu/ops/stencil_pallas.py.  That kernel permuted An into a
// dk-major order, retiled each (m, n) plane to 128-lane rows and built
// nine shifted copies of x, all to suit the TPU's vector unit.  None of
// that is needed here: An keeps its natural (27, 6, 6, l, m, n) layout
// with i innermost, so for a fixed (p, A, B) the coefficients of
// consecutive grid points are consecutive in memory.
//
// Bound: bytes.  One call reads each coefficient whose neighbour lies in
// the grid exactly once: 36 * (3l-2) * (3m-2) * 3n of the 972 * l*m*n
// when periodic (3n-2 in place of 3n when not), 4 bytes each in f32 and
// 2 in bf16.  On the periodic global 96x38x12 grid that is 157.9 MB and
// 79.0 MB, more than the 50 MB L2.  x and y add 6 l m n floats each
// (1.05 MB).  There is no reuse of a coefficient and two flops per
// coefficient, so the only thing to win is bytes in flight: the card
// needs a few MB of outstanding loads to cover the latency of its device
// memory.
//
// Two kernels live here.
//
// * The wide kernel (`stencil_matvec_*_wide`), for n divisible by the
//   vector width (4 points in f32, 8 in bf16) and 16-byte aligned
//   pointers.  A thread owns VEC neighbouring points of one grid row and
//   reads their coefficients as one 16-byte streaming load (`ld.global.cs`,
//   so the stream does not push x out of L1).  The 972 terms of a point
//   are split over the 6 threads of one block that hold one output row A
//   each.  A thread so has 162 independent 16-byte loads, fully unrolled
//   (ptxas gives it about 140 registers and keeps them in flight), and
//   the grid has (N / VEC) * 6 threads instead of N.  WIDE_QB = 16 such
//   threads with neighbouring points sit side by side, so 256 bytes of
//   every (p, A, B) row are read contiguously.  x (1 MB, read 27 times per
//   output row) comes through L1 with `ld.global.nc`: the six threads
//   that need the same window sit in one block.  The wrap in i touches
//   only the two end values of a thread's window (VEC + 2 values of x per
//   (dk, dj, B), shared by the three di).  Offsets that leave the grid in
//   k or j are skipped, so their coefficients are never read.  There is
//   no shared memory and there are no atomics: the sum has one order,
//   the same from run to run.
//
// * The general-shape kernel (`stencil_matvec_f32`, `stencil_matvec_bf16`):
//   one thread per grid point, scalar loads, any l, m, n and any
//   alignment.  It takes the shapes the wide kernel refuses.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// vector-threads of the wide kernel that sit side by side in a block
constexpr int WIDE_QB = 16;

namespace {

// ---------------------------------------------------------------------
// general-shape kernel
// ---------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void stencil_matvec_kernel(const T* __restrict__ An,
                                      const float* __restrict__ x,
                                      float* __restrict__ y,
                                      int l, int m, int n, int periodic) {
  const long long N = (long long)l * m * n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int i = (int)(idx % n);
  const int j = (int)((idx / n) % m);
  const int k = (int)(idx / ((long long)m * n));

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

#pragma unroll 1
  for (int p = 0; p < 27; ++p) {
    const int q = p % 9;
    const int di = q / 3 - 1;
    const int dj = q % 3 - 1;
    const int dk = (p < 9) ? 0 : ((p < 18) ? -1 : 1);
    const int k2 = k + dk;
    const int j2 = j + dj;
    int i2 = i + di;
    if (k2 < 0 || k2 >= l || j2 < 0 || j2 >= m) continue;
    if (i2 < 0 || i2 >= n) {
      if (!periodic) continue;
      i2 = (i2 + n) % n;
    }
    const long long src = ((long long)k2 * m + j2) * n + i2;
    float xb[6];
#pragma unroll
    for (int B = 0; B < 6; ++B) xb[B] = __ldg(x + B * N + src);
    const T* a = An + (long long)p * 36 * N + idx;
#pragma unroll
    for (int A = 0; A < 6; ++A) {
#pragma unroll
      for (int B = 0; B < 6; ++B) {
        acc[A] = fmaf(to_float(a[(A * 6 + B) * N]), xb[B], acc[A]);
      }
    }
  }
#pragma unroll
  for (int A = 0; A < 6; ++A) y[A * N + idx] = acc[A];
}

template <typename T>
int launch(const void* An, const void* x, void* y, int l, int m, int n,
           int periodic, void* stream) {
  const long long N = (long long)l * m * n;
  const int threads = 128;
  const long long blocks = (N + threads - 1) / threads;
  stencil_matvec_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)An, (const float*)x, (float*)y, l, m, n, periodic);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// wide kernel
// ---------------------------------------------------------------------

// VEC coefficients of neighbouring points as one 16-byte streaming load
template <typename T> struct Wide;

template <> struct Wide<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void load(const float* p,
                                              float (&c)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
};

template <> struct Wide<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // a bf16 is the upper half of the f32 of the same value; the lower
  // address is the lower half of the 32-bit word
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&c)[8]) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    c[0] = __uint_as_float(v.x << 16);
    c[1] = __uint_as_float(v.x & 0xffff0000u);
    c[2] = __uint_as_float(v.y << 16);
    c[3] = __uint_as_float(v.y & 0xffff0000u);
    c[4] = __uint_as_float(v.z << 16);
    c[5] = __uint_as_float(v.z & 0xffff0000u);
    c[6] = __uint_as_float(v.w << 16);
    c[7] = __uint_as_float(v.w & 0xffff0000u);
  }
};

// The second launch bound (one block per SM is enough) lets ptxas spend
// registers on loads in flight: about 140 a thread with it, 48 without,
// and the kernel is a sixth slower without.
template <typename T>
__global__ void __launch_bounds__(WIDE_QB * 6, 1)
stencil_matvec_wide_kernel(const T* __restrict__ An,
                           const float* __restrict__ x,
                           float* __restrict__ y,
                           int l, int m, int n, int periodic) {
  constexpr int VEC = Wide<T>::VEC;
  const int N = l * m * n;
  const int A = threadIdx.x / WIDE_QB;    // output row of this thread
  const int quad = blockIdx.x * WIDE_QB + threadIdx.x % WIDE_QB;
  if (quad >= N / VEC) return;
  const int idx = quad * VEC;             // first point of this thread
  const int i = idx % n;                  // n % VEC == 0: one grid row
  const int row = idx / n;
  const int j = row % m;
  const int k = row / m;
  // the two ends of the window x[i-1 .. i+VEC]: wrapped or zero
  const bool left_ok = i > 0 || periodic;
  const bool right_ok = i + VEC < n || periodic;
  const int il = i > 0 ? i - 1 : n - 1;
  const int ir = i + VEC < n ? i + VEC : 0;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

#pragma unroll
  for (int grp = 0; grp < 3; ++grp) {     // p / 9: dk = 0, -1, +1
    const int k2 = k + (grp == 0 ? 0 : (grp == 1 ? -1 : 1));
    if (k2 < 0 || k2 >= l) continue;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      const int j2 = j + dj;
      if (j2 < 0 || j2 >= m) continue;
      const float* xr = x + ((size_t)k2 * m + j2) * n;
#pragma unroll
      for (int B = 0; B < 6; ++B) {
        const float* xb = xr + (size_t)B * N;
        float xw[VEC + 2];
        xw[0] = left_ok ? __ldg(xb + il) : 0.f;
#pragma unroll
        for (int v4 = 0; v4 < VEC / 4; ++v4) {
          const float4 t =
              __ldg(reinterpret_cast<const float4*>(xb + i) + v4);
          xw[1 + 4 * v4] = t.x;
          xw[2 + 4 * v4] = t.y;
          xw[3 + 4 * v4] = t.z;
          xw[4 + 4 * v4] = t.w;
        }
        xw[VEC + 1] = right_ok ? __ldg(xb + ir) : 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {     // di = d - 1
          const int p = grp * 9 + d * 3 + (dj + 1);
          float c[VEC];
          Wide<T>::load(
              An + ((size_t)(p * 6 + A) * 6 + B) * (size_t)N + idx, c);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = fmaf(c[v], xw[v + d], acc[v]);
        }
      }
    }
  }

  float4* out = reinterpret_cast<float4*>(y + (size_t)A * N + idx);
#pragma unroll
  for (int v4 = 0; v4 < VEC / 4; ++v4)
    out[v4] = make_float4(acc[4 * v4], acc[4 * v4 + 1], acc[4 * v4 + 2],
                          acc[4 * v4 + 3]);
}

template <typename T>
int launch_wide(const void* An, const void* x, void* y, int l, int m, int n,
                int periodic, void* stream) {
  constexpr int VEC = Wide<T>::VEC;
  const long long N = (long long)l * m * n;
  if (l <= 0 || m <= 0 || n <= 0 || n % VEC != 0 || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)An | (uintptr_t)x | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (N / VEC + WIDE_QB - 1) / WIDE_QB;
  stencil_matvec_wide_kernel<T>
      <<<(unsigned)blocks, WIDE_QB * 6, 0, (cudaStream_t)stream>>>(
          (const T*)An, (const float*)x, (float*)y, l, m, n, periodic);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_matvec_f32(const void* An, const void* x, void* y,
                                  int l, int m, int n, int periodic,
                                  void* stream) {
  return launch<float>(An, x, y, l, m, n, periodic, stream);
}

extern "C" int stencil_matvec_bf16(const void* An, const void* x, void* y,
                                   int l, int m, int n, int periodic,
                                   void* stream) {
  return launch<__nv_bfloat16>(An, x, y, l, m, n, periodic, stream);
}

extern "C" int stencil_matvec_f32_wide(const void* An, const void* x,
                                       void* y, int l, int m, int n,
                                       int periodic, void* stream) {
  return launch_wide<float>(
      An, x, y, l, m, n, periodic, stream);
}

extern "C" int stencil_matvec_bf16_wide(const void* An, const void* x,
                                        void* y, int l, int m, int n,
                                        int periodic, void* stream) {
  return launch_wide<__nv_bfloat16>(
      An, x, y, l, m, n, periodic, stream);
}
