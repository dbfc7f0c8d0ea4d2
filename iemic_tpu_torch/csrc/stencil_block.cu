// Sub-block stencil product of the BGS sweep for Hopper (sm_90a).
//
//   y[a,k,j,i] = sum_{p<27, b<NB} A[p,a,b,k,j,i] * x[b, k+dk_p, j+dj_p, i+di_p]
//
// for a sub-block A (27, NA, NB, l, m, n) of the stencil tensor and x
// (NB, l, m, n), in f32 or f64, with x zero outside the grid in j and k,
// and wrapped in i when `periodic` (ops/stencil.py's `_window_index`).
//
// Replaces no TPU kernel.  The JAX package computes these products as
// XLA einsums (iemic_tpu/solvers/bgs.py `_block_apply`).  The port's
// plain version (`apply_block_plain` in ops/stencil_hopper.py, which CPU
// tensors take) gathers 27 shifted copies of x, writes the
// (27, NA, NB, l, m, n) product of a broadcast multiply and reduces it:
// three to four launches on the card that move about four times the
// bytes the product needs.  Inside the sweep's saddle FGMRES (A_uvuv,
// A_uvp, A_puv; 7 products an iteration) that was the largest block of
// device time of the ocean's Newton iteration.
//
// Bound: bytes.  Each coefficient whose neighbour lies in the grid is
// needed once: NA*NB * (3l-2) * (3m-2) * 3n of the 27*NA*NB*l*m*n when
// periodic (3n-2 in place of 3n when not).  At 96x38x12 the (27,2,2)
// block is 18.9 MB in f32, more than x and y (0.35 MB each), which stay
// in L2 and L1.  There are two flops per coefficient and no reuse, so
// what counts is bytes in flight over the whole card, and the grids are
// small: 43,776 points at 96x38x12, 24,576 at 64x32x12.
//
// Design:
// - A lane owns V neighbouring points of one grid row (V = 4 in f32, 2 in
//   f64: one 16-byte vector) and all NA output rows of them.  A warp's 32
//   lanes read 512 consecutive bytes of each (p, a, b) plane.  One test
//   of the row in k and j serves the V points, and only the row's end
//   points can leave it in i.
// - The 27 stencil offsets are split over the 9 warps of a block, 3 each,
//   so that the grid has 9 times as many threads as lanes of points (a
//   single wave on 132 SMs at the cells' shapes) and each thread has
//   3 * NA * NB independent 16-byte loads in flight, fully unrolled.  The
//   9 partial sums of a point meet in shared memory, and each output is
//   written once, coalesced.  (3 or 27 warps a block, or two vectors a
//   lane, measured slower.)
// - Coefficients are streaming loads (`ld.global.cs`): inside the sweep
//   they leave L2 to the column and line inverses and to x, which made
//   the sweep faster than loads that keep them (`ld.global.nc`), though
//   either reads alone at the same rate.  x goes through the read-only
//   path (`ld.global.nc`) with the strides it has, so a stride-0 x (the
//   saddle's `pbar.expand(1, l, m, n)`) is read without a copy.  Every
//   load is one predicated instruction (inline PTX): coefficients whose
//   row leaves the grid are not read, and a branch around each load would
//   cut the unrolled sum into blocks ptxas cannot schedule across.
// - Where a row is not a whole number of vectors or A's planes do not
//   start on 16-byte boundaries, the general layout takes the call: a
//   lane's V points are 32 apart, each with its own (k, j, i), so each
//   warp load reads 32 consecutive coefficients, one load each, wherever
//   the plane starts.
// - Offsets into x are ints (the launch checks that they fit), offsets
//   into A 64-bit.
// - The sum is in the working type, f32 or f64, as torch.sum's: per warp
//   one fma chain over its 3 offsets and b, then the 9 warps' sums in
//   order.  No atomics: the result is the same from run to run.
// - The launch goes on the caller's stream and allocates nothing, so a
//   CUDA graph records it like any other kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// warps of a block, and the stencil offsets each of them sums
constexpr int BLK_WARPS = 9;
constexpr int BLK_OFFSETS = 27 / BLK_WARPS;
constexpr int BLK_THREADS = 32 * BLK_WARPS;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<double> { static constexpr int N = 2; };

// Loads under a predicate, as one predicated instruction each.  A load
// whose predicate is false leaves its zero.

// the V coefficients of one 16-byte vector
__device__ __forceinline__ void ldvec(bool p, const float* a,
                                      float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
      "@q ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "l"(a), "r"((int)p));
}

__device__ __forceinline__ void ldvec(bool p, const double* a,
                                      double (&c)[2]) {
  c[0] = c[1] = 0.0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "@q ld.global.cs.v2.f64 {%0, %1}, [%2];\n\t}"
      : "+d"(c[0]), "+d"(c[1]) : "l"(a), "r"((int)p));
}

// one coefficient
__device__ __forceinline__ float ldone(bool p, const float* a) {
  float c = 0.f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.cs.f32 %0, [%1];\n\t}"
      : "+f"(c) : "l"(a), "r"((int)p));
  return c;
}

__device__ __forceinline__ double ldone(bool p, const double* a) {
  double c = 0.0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.cs.f64 %0, [%1];\n\t}"
      : "+d"(c) : "l"(a), "r"((int)p));
  return c;
}

// one value of x through the read-only path
__device__ __forceinline__ float ldx(bool p, const float* a) {
  float v = 0.f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v) : "l"(a), "r"((int)p));
  return v;
}

__device__ __forceinline__ double ldx(bool p, const double* a) {
  double v = 0.0;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.f64 %0, [%1];\n\t}"
      : "+d"(v) : "l"(a), "r"((int)p));
  return v;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
struct BlockArgs {
  const T* A;               // (27, NA, NB, l, m, n), planes contiguous
  long long sp, sa, sb;     // A's strides of p, a, b (elements)
  const T* x;               // (NB, l, m, n)
  int xb, xk, xj, xi;       // x's strides (elements; any, 0 too, and
                            // every offset into x fits an int)
  T* y;                     // (NA, l, m, n), contiguous
  int l, m, n, periodic;
};

// ROW: n is a whole number of vectors and A's planes start on 16-byte
// boundaries, so a lane's V points are the neighbours i0 .. i0+V-1 of one
// grid row and their coefficients of a plane one 16-byte load.  Else (the
// general layout) the V points are 32 apart, each with its own (k, j, i)
// and one load per coefficient.  The blocks of the 2x2 and smaller
// sub-blocks keep to 72 registers a thread, so that three fit an SM and
// the cells' grids run in one wave.
template <typename T, int NA, int NB, bool ROW>
__global__ void __launch_bounds__(BLK_THREADS, NA * NB <= 4 ? 3 : 1)
stencil_block_kernel(const BlockArgs<T> args) {
  constexpr int V = Vec<T>::N;
  constexpr int TILE = 32 * V;
  __shared__ T part[BLK_WARPS][NA][TILE];
  const int l = args.l, m = args.m, n = args.n;
  const int N = l * m * n;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tile0 = blockIdx.x * TILE;

  // this lane's points: slot of the tile, flat index s, (k, j, i); the
  // row layout uses the first point's only
  int slot[V], s[V], k[V], j[V], i[V];
  bool live[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    slot[v] = ROW ? lane * V + v : v * 32 + lane;
    s[v] = tile0 + slot[v];
    live[v] = s[v] < N;
    const int e = live[v] ? s[v] : 0;
    i[v] = e % n;
    j[v] = e / n % m;
    k[v] = e / n / m;
  }

  T acc[NA][V];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[a][v] = T(0);

#pragma unroll
  for (int q = 0; q < BLK_OFFSETS; ++q) {
    const int p = warp * BLK_OFFSETS + q;
    const int di = p % 9 / 3 - 1, dj = p % 3 - 1;
    const int dk = p < 9 ? 0 : (p < 18 ? -1 : 1);
    // the neighbour of each point: in the grid, and its offset in x; in
    // the row layout one test of the row in k and j, and only the row's
    // end points can leave it in i
    bool in[V], row = false;
    int off[V];
    if (ROW) {
      const int k2 = k[0] + dk, j2 = j[0] + dj;
      row = live[0] && (unsigned)k2 < (unsigned)l &&
            (unsigned)j2 < (unsigned)m;
      const int base = k2 * args.xk + j2 * args.xj;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        int i2 = i[0] + v + di;
        bool ok = row;
        if (v == 0 && i2 < 0) {
          ok = ok && args.periodic;
          i2 += n;
        }
        if (v == V - 1 && i2 >= n) {
          ok = ok && args.periodic;
          i2 -= n;
        }
        in[v] = ok;
        off[v] = base + i2 * args.xi;
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k2 = k[v] + dk, j2 = j[v] + dj;
        int i2 = i[v] + di;
        bool ok = live[v] && (unsigned)k2 < (unsigned)l &&
                  (unsigned)j2 < (unsigned)m;
        if (args.periodic)
          i2 = i2 < 0 ? i2 + n : (i2 >= n ? i2 - n : i2);
        else
          ok = ok && (unsigned)i2 < (unsigned)n;
        in[v] = ok;
        off[v] = k2 * args.xk + j2 * args.xj + i2 * args.xi;
      }
    }
    T xv[NB][V];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < V; ++v)
        xv[b][v] = ldx(in[v], args.x + (b * args.xb + off[v]));
    const T* ap = args.A + p * args.sp;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const T* plane = ap + a * args.sa + b * args.sb;
        T c[V];
        if (ROW) {
          // wherever the row lies in the grid, some point of the vector
          // has its neighbour in it (V >= 2)
          ldvec(row, plane + s[0], c);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) c[v] = ldone(in[v], plane + s[v]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[a][v] = fmadd(c[v], xv[b][v], acc[a][v]);
      }
  }

#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int v = 0; v < V; ++v) part[warp][a][slot[v]] = acc[a][v];
  __syncthreads();
  for (int o = threadIdx.x; o < NA * TILE; o += BLK_THREADS) {
    const int a = o / TILE, t = o % TILE;
    if (tile0 + t < N) {
      T sum = part[0][a][t];
#pragma unroll
      for (int w = 1; w < BLK_WARPS; ++w) sum += part[w][a][t];
      args.y[(long long)a * N + tile0 + t] = sum;
    }
  }
}

template <typename T, int NA, int NB>
int launch_shape(const BlockArgs<T>& args, int row, cudaStream_t stream) {
  constexpr int TILE = 32 * Vec<T>::N;
  const long long N = (long long)args.l * args.m * args.n;
  const unsigned blocks = (unsigned)((N + TILE - 1) / TILE);
  if (row)
    stencil_block_kernel<T, NA, NB, true>
        <<<blocks, BLK_THREADS, 0, stream>>>(args);
  else
    stencil_block_kernel<T, NA, NB, false>
        <<<blocks, BLK_THREADS, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* A, long long sp, long long sa, long long sb,
           const void* x, long long xb, long long xk, long long xj,
           long long xi, void* y, int na, int nb, int l, int m, int n,
           int periodic, int row, void* stream) {
  constexpr int V = Vec<T>::N;
  const long long N = (long long)l * m * n;
  // every offset into x, a neighbour's outside the grid too, fits an int
  const long long reach = (xb < 0 ? -xb : xb) * nb +
                          (xk < 0 ? -xk : xk) * (l + 1) +
                          (xj < 0 ? -xj : xj) * (m + 1) +
                          (xi < 0 ? -xi : xi) * (n + 1);
  if (l <= 0 || m <= 0 || n <= 0 || N > 0x7fffffffLL - 32 * V ||
      reach > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)A | (uintptr_t)x | (uintptr_t)y) % sizeof(T) ||
      (row && ((uintptr_t)A % 16 || n % V || sp % V ||
               (na > 1 && sa % V) || (nb > 1 && sb % V))))
    return (int)cudaErrorMisalignedAddress;
  const BlockArgs<T> args{(const T*)A, sp, sa, sb, (const T*)x, (int)xb,
                          (int)xk, (int)xj, (int)xi, (T*)y, l, m, n,
                          periodic};
  const cudaStream_t s = (cudaStream_t)stream;
  // the sub-block shapes of the sweep (2x2, 2x1, 1x2), the saddle MG's
  // 3x3 and the Teko couplings (4x2, 2x4): BLOCK_SHAPES in
  // ops/stencil_hopper.py
#define STENCIL_BLOCK_SHAPE(NA_, NB_) \
  if (na == NA_ && nb == NB_) return launch_shape<T, NA_, NB_>(args, row, s);
  STENCIL_BLOCK_SHAPE(1, 1)
  STENCIL_BLOCK_SHAPE(1, 2)
  STENCIL_BLOCK_SHAPE(2, 1)
  STENCIL_BLOCK_SHAPE(2, 2)
  STENCIL_BLOCK_SHAPE(3, 3)
  STENCIL_BLOCK_SHAPE(2, 4)
  STENCIL_BLOCK_SHAPE(4, 2)
#undef STENCIL_BLOCK_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int stencil_block_f32(const void* A, long long sp, long long sa,
                                 long long sb, const void* x, long long xb,
                                 long long xk, long long xj, long long xi,
                                 void* y, int na, int nb, int l, int m,
                                 int n, int periodic, int row,
                                 void* stream) {
  return launch<float>(A, sp, sa, sb, x, xb, xk, xj, xi, y, na, nb, l, m,
                       n, periodic, row, stream);
}

extern "C" int stencil_block_f64(const void* A, long long sp, long long sa,
                                 long long sb, const void* x, long long xb,
                                 long long xk, long long xj, long long xi,
                                 void* y, int na, int nb, int l, int m,
                                 int n, int periodic, int row,
                                 void* stream) {
  return launch<double>(A, sp, sa, sb, x, xb, xk, xj, xi, y, na, nb, l, m,
                        n, periodic, row, stream);
}
