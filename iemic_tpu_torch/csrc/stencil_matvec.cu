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
// * The general-shape kernel (`stencil_matvec_f32`, `stencil_matvec_bf16`)
//   for any l, m, n and any element alignment: every call the wide kernel
//   refuses.  A row of n points is then not a whole number of 16-byte
//   vectors, and a (p, A, B) plane starts wherever (p*36 + A*6 + B) * N
//   puts it, so the wide kernel's row-aligned vectors do not exist.  What
//   the design does instead:
//   - A lane owns a pair of neighbouring points of the flat index and
//     GEN_ROWS = 3 output rows A of them; a warp holds 32 neighbouring
//     pairs, a block the two warps of rows 0-2 and 3-5.  Each warp load
//     reads 64 consecutive coefficients of one plane (256 bytes in f32,
//     128 in bf16) wherever the plane starts.
//   - A pair's coefficients are one 8-byte (f32) or 4-byte (bf16) load
//     where the pair is aligned to that size, else two loads.  Which
//     planes are aligned depends only on the parity of An's start (in
//     elements), of N and of B (the plane index has the parity of B), so
//     the launch picks one of four instantiations and the choice costs
//     nothing inside the sum.
//   - Three rows per lane share the x window: x is loaded once for three
//     rows and the pair's centres are each other's neighbours.  Three rows
//     and two points keep 6 accumulators and 162 * 3 fully unrolled
//     coefficient loads; with __launch_bounds__(64, 6) ptxas gives a
//     thread 168 registers, most of them loads in flight.
//   - Each point's (k, j, i), its wrap offsets in i and its in-grid
//     tests are computed once.  Every load is one predicated instruction
//     (inline PTX): coefficients whose neighbour leaves the grid in k or
//     j (or in i when closed) are not read, and a branch around a load
//     would cut the unrolled sum into blocks ptxas cannot schedule
//     across.  A coefficient read for its pair partner only multiplies an
//     x of 0.
//   - Addresses are a base plus a constant times N: one IMAD.WIDE.U32.
//   - Each output sums its terms as the wide kernel does, one fmaf chain
//     from 0 in the order dk = 0, -1, +1; dj; B; di.  Where both kernels
//     run they give the same value, bit for bit (up to the sign of a
//     zero sum).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// vector-threads of the wide kernel that sit side by side in a block
constexpr int WIDE_QB = 16;

namespace {

// ---------------------------------------------------------------------
// general-shape kernel
// ---------------------------------------------------------------------

// A lane of the general kernel owns a pair of neighbouring points and
// GEN_ROWS output rows A of them; a block holds the 6 / GEN_ROWS warps of
// 32 pairs, and GEN_MIN_BLOCKS of them fit an SM (ptxas: 168 registers).
constexpr int GEN_ROWS = 3;
constexpr int GEN_THREADS = 6 / GEN_ROWS * 32;
constexpr int GEN_MIN_BLOCKS = 6;

// Loads under a predicate, as one predicated instruction each (inline
// PTX): a branch around each load would cut the unrolled sum into blocks
// that ptxas cannot schedule across, and only few loads would be in
// flight.  A load whose predicate is false leaves its zero.

// x through L1 (ld.global.nc)
__device__ __forceinline__ float ldx(bool p, const float* a) {
  float v = 0.f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v) : "l"(a), "r"((int)p));
  return v;
}

// two neighbouring coefficients of one plane as streaming loads
// (ld.global.cs, see the wide kernel): one load where the pair is
// aligned to its size (load2), else one load each (load1)
template <typename T> struct Pair;

template <> struct Pair<float> {
  static __device__ __forceinline__ void load2(bool p, const float* a,
                                               float (&c)[2]) {
    c[0] = c[1] = 0.f;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
        "@q ld.global.cs.v2.f32 {%0, %1}, [%2];\n\t}"
        : "+f"(c[0]), "+f"(c[1]) : "l"(a), "r"((int)p));
  }
  static __device__ __forceinline__ float load1(bool p, const float* a) {
    float c = 0.f;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
        "@q ld.global.cs.f32 %0, [%1];\n\t}"
        : "+f"(c) : "l"(a), "r"((int)p));
    return c;
  }
};

// a bf16 is the upper half of the f32 of the same value (as in Wide)
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ void load2(bool p,
                                               const __nv_bfloat16* a,
                                               float (&c)[2]) {
    unsigned w = 0;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
        "@q ld.global.cs.b32 %0, [%1];\n\t}"
        : "+r"(w) : "l"(a), "r"((int)p));
    c[0] = __uint_as_float(w << 16);
    c[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ float load1(bool p,
                                                const __nv_bfloat16* a) {
    unsigned short h = 0;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
        "@q ld.global.cs.b16 %0, [%1];\n\t}"
        : "+h"(h) : "l"(a), "r"((int)p));
    return __uint_as_float((unsigned)h << 16);
  }
};

// BASE_ODD: An does not start on a pair boundary; N_ODD: l*m*n is odd.
// The pairs of a plane are aligned unless BASE_ODD ^ (N_ODD && B odd):
// the plane index (p*6 + A)*6 + B has the parity of B.
template <typename T, bool BASE_ODD, bool N_ODD>
__global__ void __launch_bounds__(GEN_THREADS, GEN_MIN_BLOCKS)
stencil_matvec_general_kernel(const T* __restrict__ An,
                              const float* __restrict__ x,
                              float* __restrict__ y,
                              int l, int m, int n, int periodic) {
  const int N = l * m * n;
  const int A0 = threadIdx.x / 32 * GEN_ROWS;   // first output row
  const int e0 = 2 * (blockIdx.x * 32 + threadIdx.x % 32);
  // per point e0 + h: in the grid; offsets of the left and right
  // neighbour in i (wrapped at the row's ends); whether they are read
  int k[2], j[2], lo[2], ro[2];
  bool in[2], lok[2], rok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = e0 + h;
    in[h] = e < N;
    const int i = e % n;
    j[h] = e / n % m;
    k[h] = e / n / m;
    lo[h] = i > 0 ? -1 : n - 1;
    ro[h] = i < n - 1 ? 1 : 1 - n;
    lok[h] = in[h] && (i > 0 || periodic);
    rok[h] = in[h] && (i < n - 1 || periodic);
  }
  // addresses: a base plus a constant times N bytes
  const unsigned Nu = N;
  const char* an = (const char*)(An + (size_t)A0 * 6 * N + e0);
  float acc[GEN_ROWS][2];
#pragma unroll
  for (int r = 0; r < GEN_ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;

  // the wide kernel's order: dk = 0, -1, +1; dj; B; di
#pragma unroll
  for (int grp = 0; grp < 3; ++grp) {
    const int dk = grp == 0 ? 0 : (grp == 1 ? -1 : 1);
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      bool ok[2], need[3][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[h] = in[h] && (unsigned)(k[h] + dk) < (unsigned)l &&
                (unsigned)(j[h] + dj) < (unsigned)m;
        need[0][h] = ok[h] && lok[h];
        need[1][h] = ok[h];
        need[2][h] = ok[h] && rok[h];
      }
      // x[s], x[s+1] are the pair's centres and, inside a row, each
      // other's neighbours; the other neighbours are read apart
      const bool in_row0 = ro[0] == 1, in_row1 = lo[1] == -1;
      const bool get0 = ok[0] || (ok[1] && in_row1);
      const bool get1 = ok[1] || (ok[0] && in_row0);
      const bool wrap0 = !in_row0 && need[2][0];
      const bool wrap1 = !in_row1 && need[0][1];
      const float* xs = x + (e0 + (dk * m + dj) * n);
      const char* xc = (const char*)xs;
      const char* xl0 = (const char*)(xs + lo[0]);
      const char* xr0 = (const char*)(xs + ro[0]);
      const char* xl1 = (const char*)(xs + 1 + lo[1]);
      const char* xr1 = (const char*)(xs + 1 + ro[1]);
#pragma unroll
      for (int B = 0; B < 6; ++B) {
        const size_t xo = (size_t)(4u * B) * Nu;      // x[B]
        const float c0 = ldx(get0, (const float*)(xc + xo));
        const float c1 = ldx(get1, (const float*)(xc + xo) + 1);
        const float w0 = ldx(wrap0, (const float*)(xr0 + xo));
        const float w1 = ldx(wrap1, (const float*)(xl1 + xo));
        float xw[2][3];
        xw[0][0] = ldx(need[0][0], (const float*)(xl0 + xo));
        xw[0][1] = ok[0] ? c0 : 0.f;
        xw[0][2] = in_row0 ? (ok[0] ? c1 : 0.f) : w0;
        xw[1][0] = in_row1 ? (ok[1] ? c0 : 0.f) : w1;
        xw[1][1] = ok[1] ? c1 : 0.f;
        xw[1][2] = ldx(need[2][1], (const float*)(xr1 + xo));
        const bool odd = BASE_ODD ^ (N_ODD && (B & 1));
#pragma unroll
        for (int d = 0; d < 3; ++d) {     // di = d - 1
          const int p = grp * 9 + d * 3 + (dj + 1);
#pragma unroll
          for (int r = 0; r < GEN_ROWS; ++r) {
            const unsigned plane = ((p * 6 + r) * 6 + B) * sizeof(T);
            const T* a = (const T*)(an + (size_t)plane * Nu);
            // a coefficient that is not needed multiplies an x of 0
            float c[2];
            if (odd) {
              c[0] = Pair<T>::load1(need[d][0], a);
              c[1] = Pair<T>::load1(need[d][1], a + 1);
            } else {
              Pair<T>::load2(need[d][0] || need[d][1], a, c);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc[r][h] = fmaf(c[h], xw[h][d], acc[r][h]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < GEN_ROWS; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (in[h]) y[(size_t)(A0 + r) * N + e0 + h] = acc[r][h];
}

template <typename T, bool BASE_ODD, bool N_ODD>
void launch_general(const void* An, const void* x, void* y, int l, int m,
                    int n, int periodic, int blocks, cudaStream_t stream) {
  stencil_matvec_general_kernel<T, BASE_ODD, N_ODD>
      <<<(unsigned)blocks, GEN_THREADS, 0, stream>>>(
          (const T*)An, (const float*)x, (float*)y, l, m, n, periodic);
}

template <typename T>
int launch(const void* An, const void* x, void* y, int l, int m, int n,
           int periodic, int blocks, int threads, int points,
           void* stream) {
  const long long N = (long long)l * m * n;
  if (l <= 0 || m <= 0 || n <= 0 || N > 0x7fffffffLL - 64)
    return (int)cudaErrorInvalidValue;
  if (threads != GEN_THREADS || points != 2 ||
      (long long)blocks != (N + 63) / 64)
    return (int)cudaErrorInvalidConfiguration;
  if ((uintptr_t)An % sizeof(T) != 0 || ((uintptr_t)x | (uintptr_t)y) % 4)
    return (int)cudaErrorMisalignedAddress;
  const bool base_odd = (uintptr_t)An % (2 * sizeof(T)) != 0;
  const bool n_odd = N % 2 != 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (base_odd && n_odd)
    launch_general<T, true, true>(An, x, y, l, m, n, periodic, blocks, s);
  else if (base_odd)
    launch_general<T, true, false>(An, x, y, l, m, n, periodic, blocks, s);
  else if (n_odd)
    launch_general<T, false, true>(An, x, y, l, m, n, periodic, blocks, s);
  else
    launch_general<T, false, false>(An, x, y, l, m, n, periodic, blocks, s);
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
                                  int blocks, int threads, int points,
                                  void* stream) {
  return launch<float>(An, x, y, l, m, n, periodic, blocks, threads,
                       points, stream);
}

extern "C" int stencil_matvec_bf16(const void* An, const void* x, void* y,
                                   int l, int m, int n, int periodic,
                                   int blocks, int threads, int points,
                                   void* stream) {
  return launch<__nv_bfloat16>(An, x, y, l, m, n, periodic, blocks,
                               threads, points, stream);
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
