// Fused regression map step for Hopper (sm_90a): the SGPR statistics
//
//     b = sf2 * sum_i w_i                    ()
//     C = knm^T (w . Y)                      (m, d)
//     D = (knm . w)^T knm                    (m, m)
//
// with knm[i, a] = sf2 * exp(-1/2 sum_q (x_iq - z_aq)^2 / ell_q^2), built
// tile by tile in shared memory and never stored whole.
//
// Replaces the TPU kernel src/repro/kernels/reg_stats/kernel.py,
// reg_stats_pallas (body _reg_stats_kernel), forward only.
//
// What bounds it on the H100: operations.  D alone is n*m*(m+1)/2
// multiply-adds (2.6e11 at n = 1e6, m = 512) against ~52 MB of input, far
// above the card's balance point of ~20 flop/byte in f32.  The design:
//   * The TPU carries the D/C/b accumulators from one step of a sequential
//     n-grid to the next.  Here blocks run in parallel and in no order, and
//     at m = 512 there are only 36 upper 64x64 D tiles for 132 SMs, so the
//     grid is (n-slice, upper D tile): each block owns one tile (a, b) with
//     a <= b and one slice of rows, stages RC rows at a time, builds the
//     (RC, 64) slabs ka*w and kb in shared memory and accumulates its 64x64
//     tile in registers (a 4x4 micro-tile per thread, FMAs on the CUDA
//     cores).  Only the upper tiles are computed; the lower half is their
//     mirror.
//   * C is accumulated on the diagonal tiles (a == b), b on tile 0, in the
//     same pass.  On a diagonal tile kb is ka, so its slab is built once.
//   * A second small kernel sums the per-slice partials in a fixed order
//     (slice 0, 1, ...) in f64 and mirrors D: no atomics, so results are
//     deterministic, and splitting n keeps the error of a 1e6-row sum
//     small.  Within a slice each RC-row chunk is summed on its own and
//     folded into the running tile with Kahan compensation.
//   * The exponent is evaluated directly as sum_q (x_q - z_q)^2 * inv_q
//     (q FMAs per entry).  The Pallas kernel's expanded form alpha + M.Zc is
//     not anchored and cancels in f32 for inputs with large offsets; the
//     direct form has no such cancellation and costs little at q = 8.
//   * Ragged edges are masked, never padded into the result: rows past n
//     (or past the slice) carry w = 0 and x = y = 0; inducing points past m
//     carry z = 0 and are never written out; q and d are loop bounds.  No
//     result depends on the tile size.
//   * One template, instantiated for float (the TPU kernel's f32 contract)
//     and double.  At sgpr-synth-1m, f32 tiles move the served mean far
//     outside its budget, and f32 outputs make I + beta L^-1 D L^-T
//     indefinite, because Sigma = Kmm + beta*D is ill-conditioned (ROADMAP
//     Queue 3).  So f64 callers get the double instantiation (34 TFLOP/s of
//     f64 on the H100 SXM's CUDA cores, half the f32 rate).
//
// wgmma, TMA and pipelining are for later work.  C interface, bound with
// ctypes from src/repro_torch/kernels/reg_stats/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // D tile edge
constexpr int RC = 32;   // rows staged per chunk
constexpr int NT = 256;  // threads per block: 16 x 16, a 4x4 micro-tile each

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// Four consecutive shared-memory values (16-byte aligned) into registers.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 lo = *reinterpret_cast<const double2*>(p);
  const double2 hi = *reinterpret_cast<const double2*>(p + 2);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename T>
__global__ void __launch_bounds__(NT)
reg_stats_tiles(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ w, const T* __restrict__ z,
                const T* __restrict__ hp, int n, int m, int q, int d,
                int rows_per_slice, int nts, T* __restrict__ part_d,
                T* __restrict__ part_c, T* __restrict__ part_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kaw = reinterpret_cast<T*>(smem_raw);  // [RC][TM]  ka * w
  T* kb = kaw + RC * TM;                    // [RC][TM]
  T* zaT = kb + RC * TM;                    // [q][TM]
  T* zbT = zaT + q * TM;                    // [q][TM]
  T* xs = zbT + q * TM;                     // [RC][q]
  T* ys = xs + RC * q;                      // [RC][d]
  T* ws = ys + RC * d;                      // [RC]
  T* inv = ws + RC;                         // [q]
  T* cacc = inv + q;                        // [TM][d]

  const int slice = blockIdx.x;
  const int tile = blockIdx.y;
  int a = 0, rem = tile;
  while (rem >= nts - a) {
    rem -= nts - a;
    ++a;
  }
  const int b = a + rem;
  const bool diag = a == b;
  const int a0 = a * TM, b0 = b * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T sf2 = hp[0];

  for (int e = tid; e < q; e += NT) inv[e] = hp[1 + e];
  for (int e = tid; e < q * TM; e += NT) {
    const int k = e / TM, i = e % TM;
    zaT[e] = a0 + i < m ? z[(size_t)(a0 + i) * q + k] : T(0);
    zbT[e] = b0 + i < m ? z[(size_t)(b0 + i) * q + k] : T(0);
  }
  if (diag)
    for (int e = tid; e < TM * d; e += NT) cacc[e] = T(0);

  T tot[4][4], comp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = comp[i][j] = T(0);
  T wsum = 0;

  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  __syncthreads();

  for (long r0 = lo; r0 < hi; r0 += RC) {
    const long xlim = (hi - r0) * q, ylim = (hi - r0) * d;
    for (int e = tid; e < RC * q; e += NT) xs[e] = e < xlim ? x[r0 * q + e] : T(0);
    for (int e = tid; e < RC * d; e += NT) ys[e] = e < ylim ? y[r0 * d + e] : T(0);
    for (int e = tid; e < RC; e += NT) ws[e] = r0 + e < hi ? w[r0 + e] : T(0);
    __syncthreads();

    for (int e = tid; e < RC * TM; e += NT) {
      const int r = e / TM, i = e % TM;
      const T* xr = xs + r * q;
      T sa = 0, sb = 0;
      for (int k = 0; k < q; ++k) {
        const T da = xr[k] - zaT[k * TM + i];
        sa = fma_t(da * da, inv[k], sa);
        if (!diag) {
          const T db = xr[k] - zbT[k * TM + i];
          sb = fma_t(db * db, inv[k], sb);
        }
      }
      const T ka = sf2 * exp_t(T(-0.5) * sa);
      kaw[e] = ws[r] * ka;
      kb[e] = diag ? ka : sf2 * exp_t(T(-0.5) * sb);
    }
    __syncthreads();

    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll 4
    for (int r = 0; r < RC; ++r) {
      T ar[4], br[4];
      load4(kaw + r * TM + ty * 4, ar);
      load4(kb + r * TM + tx * 4, br);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(ar[i], br[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // Kahan: tot += acc
        const T yv = acc[i][j] - comp[i][j];
        const T tv = tot[i][j] + yv;
        comp[i][j] = (tv - tot[i][j]) - yv;
        tot[i][j] = tv;
      }

    if (diag) {  // C rows of this tile; each entry owned by one thread
      for (int e = tid; e < TM * d; e += NT) {
        const int i = e / d, c = e % d;
        T s = 0;
        for (int r = 0; r < RC; ++r) s = fma_t(kaw[r * TM + i], ys[r * d + c], s);
        cacc[e] += s;
      }
    }
    if (tile == 0 && tid == 0) {
      T s = 0;
      for (int r = 0; r < RC; ++r) s += ws[r];
      wsum += s;
    }
    __syncthreads();
  }

  T* pd = part_d + ((size_t)slice * gridDim.y + tile) * TM * TM;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pd[(ty * 4 + i) * TM + tx * 4 + j] = tot[i][j];
  if (diag) {
    T* pc = part_c + ((size_t)slice * nts * TM + a0) * d;
    for (int e = tid; e < TM * d; e += NT) pc[e] = cacc[e];
  }
  if (tile == 0 && tid == 0) part_b[slice] = sf2 * wsum;
}

// Fixed-order f64 sum of the per-slice partials; D's lower half mirrors
// the upper tiles, so D is exactly symmetric.
template <typename T>
__global__ void reg_stats_reduce(const T* __restrict__ part_d,
                                 const T* __restrict__ part_c,
                                 const T* __restrict__ part_b,
                                 int n_slices, int nts, int m, int d,
                                 double* __restrict__ D, double* __restrict__ C,
                                 double* __restrict__ b) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  if (e < (long)m * m) {
    const int r = e / m, c = e % m;
    const int lo = min(r, c), hi = max(r, c);
    const int ta = lo / TM, tb = hi / TM;
    const long tile = (long)ta * nts - (long)ta * (ta - 1) / 2 + (tb - ta);
    const size_t off = (size_t)tile * TM * TM + (lo % TM) * TM + hi % TM;
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl)
      s += part_d[(size_t)sl * n_tiles * TM * TM + off];
    D[e] = s;
  }
  if (e < (long)m * d) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl)
      s += part_c[(size_t)sl * nts * TM * d + e];
    C[e] = s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_b[sl];
    *b = s;
  }
}

template <typename T>
int launch(const T* x, const T* y, const T* w, const T* z, const T* hp, int n,
           int m, int q, int d, int n_slices, int rows_per_slice, T* part_d,
           T* part_c, T* part_b, double* D, double* C, double* b, void* stream) {
  const int nts = (m + TM - 1) / TM;
  const int n_tiles = nts * (nts + 1) / 2;
  const size_t smem = sizeof(T) * (2 * RC * TM + 2 * q * TM + RC * q +
                                   RC * d + RC + q + TM * d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reg_stats_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  reg_stats_tiles<T><<<dim3(n_slices, n_tiles), NT, smem, s>>>(
      x, y, w, z, hp, n, m, q, d, rows_per_slice, nts, part_d, part_c, part_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * m > (long)m * d ? (long)m * m : (long)m * d;
  if (total < 1) total = 1;
  reg_stats_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_d, part_c, part_b, n_slices, nts, m, d, D, C, b);
  return cudaGetLastError();
}

}  // namespace

// x (n,q), y (n,d), w (n,), z (m,q), hp = [sf2, 1/ell^2 (q)]: contiguous, one
// dtype.  Scratch in that dtype: part_d (n_slices, T, 64, 64), part_c
// (n_slices, nts*64, d), part_b (n_slices,) with nts = ceil(m/64) and
// T = nts(nts+1)/2.  Outputs D (m,m), C (m,d), b (): f64.
// Returns cudaGetLastError().
extern "C" int reg_stats_f32(const float* x, const float* y, const float* w,
                             const float* z, const float* hp, int n, int m,
                             int q, int d, int n_slices, int rows_per_slice,
                             float* part_d, float* part_c, float* part_b,
                             double* D, double* C, double* b, void* stream) {
  return launch<float>(x, y, w, z, hp, n, m, q, d, n_slices, rows_per_slice,
                       part_d, part_c, part_b, D, C, b, stream);
}

extern "C" int reg_stats_f64(const double* x, const double* y, const double* w,
                             const double* z, const double* hp, int n, int m,
                             int q, int d, int n_slices, int rows_per_slice,
                             double* part_d, double* part_c, double* part_b,
                             double* D, double* C, double* b, void* stream) {
  return launch<double>(x, y, w, z, hp, n, m, q, d, n_slices, rows_per_slice,
                        part_d, part_c, part_b, D, C, b, stream);
}
