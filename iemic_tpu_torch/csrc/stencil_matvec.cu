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
// with i innermost, so neighbouring threads (neighbouring i) read
// neighbouring coefficient addresses, and every coefficient is read
// exactly once.
//
// Bound: coefficient bytes.  One call streams 972 * l*m*n coefficients
// (4 bytes each in f32, 2 in bf16) from device memory; x (6 l m n
// floats) and y are small beside it and x stays in L2 across the 27
// reuses of each entry.  Design: one thread per grid point (k, j, i)
// keeps its six f32 accumulators in registers, loops over the 27
// offsets and the 6 source variables, and handles the boundary itself.
// Shared-memory tiling and TMA are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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
