// Psi statistics of the Bayesian GPLVM map step for Hopper (sm_90a)
//
//     psi2:  D[a, b] = sf2^2 sum_i w_i prod_q (1 + 2 s_iq / l_q^2)^-1/2
//                      exp(-(z_aq - z_bq)^2 / (4 l_q^2)
//                          - (mu_iq - zbar_abq)^2 / (l_q^2 + 2 s_iq))    (m, m)
//            with zbar_ab = (z_a + z_b) / 2, summed over q in the exponent;
//     psi1:  P[i, a] = sf2 prod_q (1 + s_iq / l_q^2)^-1/2
//                      exp(-1/2 sum_q (mu_iq - z_aq)^2 / (l_q^2 + s_iq))  (n, m)
//
// Replaces the TPU kernels src/repro/kernels/psi_stats/kernel.py,
// psi2_pallas (body _psi2_kernel) and psi1_pallas (body _psi1_kernel),
// forward only (the wrapper's autograd.Function recomputes the plain
// version for the backward, as the JAX custom_vjp does).
//
// What bounds them on the H100:
//   * psi2: operations.  Each (row, pair) costs one exp and ~3q FP
//     operations, n*m(m+1)/2 pairs for the upper half: at gplvm-usps
//     (n = 4649, m = 150, q = 10) 5.3e7 exps and ~1.7e9 flops against
//     ~0.9 MB of input.  In f32 the exp runs on the SFU (16 a clock per SM,
//     1/8 of the FMA issue rate); in f64 it is a libdevice polynomial of
//     ~16 DFMAs on the CUDA cores, so the exps dominate.
//   * psi1: bytes at large n (it writes the (n, m) output once, ~3q+1 flops
//     and one exp per entry), operations at small n.
//
// The design:
//   * The TPU accumulates D over a sequential n-grid.  Blocks on Hopper run
//     in parallel in no order, and gplvm-usps has only 6 upper 64x64 D tiles
//     (m = 150) for 132 SMs, so psi2's grid is (n-slice, upper D tile):
//     each block owns one tile (a, b) with a <= b and one slice of rows,
//     stages RC rows at a time in shared memory (mu, 1/(l^2 + 2s), the row's
//     log-normaliser and weight, computed while staging) and accumulates its
//     64x64 tile in registers, 4x4 pairs per thread.  A second kernel sums
//     the slice partials in a fixed order (slice 0, 1, ...) in f64, mirrors
//     the upper tiles into D and scales by sf2^2: no atomics, so D is
//     deterministic and exactly symmetric.
//   * The exponent is evaluated in its direct form per pair,
//     static_ab + lognorm_i - sum_q (mu_iq - zbar_abq)^2 / den_iq, from the
//     half inducing inputs z/2 held in shared memory (zbar = z_a/2 + z_b/2).
//     The Pallas body expands the square into alpha_i + M_i . Zb_ab for the
//     MXU; its terms are of order mu^2/den while their sum can be near 0, so
//     it cancels.  The direct form does not.
//   * Ragged edges are masked, never padded into a result: rows past the
//     slice are not visited, zero-weight rows are skipped (a block-uniform
//     branch), inducing points past m carry z = 0 and are never written.
//     q is a loop bound.  No result depends on the tile size.
//   * psi1 is one pass over (32-row x 64-column) output tiles; each block
//     stages its rows and the tile's z in shared memory and writes every
//     output entry once, coalesced.
//   * One template, instantiated for float (the TPU kernels' f32 contract)
//     and double: f32 map statistics break the q(u) factorisation at full
//     width (ROADMAP Queue 3), so f64 callers get the double instantiation.
//
// wgmma, TMA and pipelining are for later work.  C interface, bound with
// ctypes from src/repro_torch/kernels/psi_stats/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // psi2 D tile edge
constexpr int RC = 32;   // psi2 rows staged per chunk
constexpr int NT = 256;  // threads per block (psi2: 16 x 16, 4x4 pairs each)
constexpr int PR = 32;   // psi1 rows per block
constexpr int PC = 64;   // psi1 columns per block

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }
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

// Stage rows [r0, r0 + nr) of q(X): mu, 1/(l^2 + c s) and the row's
// log-normaliser -1/2 sum_q log1p(c s / l^2) (c = 2 for psi2, 1 for psi1).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ mu,
                                           const T* __restrict__ s, long r0,
                                           int nr, int q, T c, const T* ell2,
                                           const T* il2, T* mus, T* invs,
                                           T* lns) {
  for (int e = threadIdx.x; e < nr * q; e += blockDim.x) {
    const int k = e % q;
    mus[e] = mu[r0 * q + e];
    invs[e] = T(1) / fma_t(c, s[r0 * q + e], ell2[k]);
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    T acc = 0;
    for (int k = 0; k < q; ++k) acc += log1p_t(c * s[(r0 + r) * q + k] * il2[k]);
    lns[r] = T(-0.5) * acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
psi2_tiles(const T* __restrict__ mu, const T* __restrict__ s,
           const T* __restrict__ w, const T* __restrict__ z,
           const T* __restrict__ hp, int n, int m, int q, int rows_per_slice,
           int nts, T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* haT = reinterpret_cast<T*>(smem_raw);  // [q][TM]  z_a / 2
  T* hbT = haT + q * TM;                    // [q][TM]  z_b / 2
  T* mus = hbT + q * TM;                    // [RC][q]
  T* invs = mus + RC * q;                   // [RC][q]  1 / (l^2 + 2 s)
  T* lns = invs + RC * q;                   // [RC]     log-normaliser
  T* ws = lns + RC;                         // [RC]
  T* ell2 = ws + RC;                        // [q]
  T* il2 = ell2 + q;                        // [q]

  const int slice = blockIdx.x;
  const int tile = blockIdx.y;
  int a = 0, rem = tile;
  while (rem >= nts - a) {
    rem -= nts - a;
    ++a;
  }
  const int b = a + rem;
  const int a0 = a * TM, b0 = b * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < q; e += NT) {
    ell2[e] = hp[1 + e];
    il2[e] = hp[1 + q + e];
  }
  for (int e = tid; e < q * TM; e += NT) {
    const int k = e / TM, i = e % TM;
    haT[e] = a0 + i < m ? T(0.5) * z[(size_t)(a0 + i) * q + k] : T(0);
    hbT[e] = b0 + i < m ? T(0.5) * z[(size_t)(b0 + i) * q + k] : T(0);
  }
  __syncthreads();

  // static_ab = -(z_a - z_b)^2 / (4 l^2) = -(z_a/2 - z_b/2)^2 / l^2
  T st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = T(0);
  for (int k = 0; k < q; ++k) {
    T ha[4], hb[4];
    load4(haT + k * TM + ty * 4, ha);
    load4(hbT + k * TM + tx * 4, hb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T d = ha[i] - hb[j];
        st[i][j] = fma_t(-(d * il2[k]), d, st[i][j]);
      }
  }

  T tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = T(0);

  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  for (long r0 = lo; r0 < hi; r0 += RC) {
    const int nr = (int)min((long)RC, hi - r0);
    stage_rows(mu, s, r0, nr, q, T(2), ell2, il2, mus, invs, lns);
    for (int r = tid; r < nr; r += NT) ws[r] = w[r0 + r];
    __syncthreads();

    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    for (int r = 0; r < nr; ++r) {
      const T wr = ws[r];
      if (wr == T(0)) continue;  // block-uniform: masked rows cost nothing
      T e[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) e[i][j] = st[i][j] + lns[r];
      for (int k = 0; k < q; ++k) {
        const T mv = mus[r * q + k], iv = invs[r * q + k];
        T ha[4], hb[4];
        load4(haT + k * TM + ty * 4, ha);
        load4(hbT + k * TM + tx * 4, hb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T ua = mv - ha[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T d = ua - hb[j];  // mu - zbar_ab
            e[i][j] = fma_t(-(d * iv), d, e[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(wr, exp_t(e[i][j]), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] += acc[i][j];
    __syncthreads();
  }

  T* pd = part + ((size_t)slice * gridDim.y + tile) * TM * TM;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pd[(ty * 4 + i) * TM + tx * 4 + j] = tot[i][j];
}

// Fixed-order f64 sum of the per-slice partials, times sf2^2; D's lower
// half mirrors the upper tiles, so D is exactly symmetric.
template <typename T>
__global__ void psi2_reduce(const T* __restrict__ part,
                            const T* __restrict__ hp, int n_slices, int nts,
                            int m, double* __restrict__ D) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)m * m) return;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  const int r = e / m, c = e % m;
  const int lo = min(r, c), hi = max(r, c);
  const int ta = lo / TM, tb = hi / TM;
  const long tile = (long)ta * nts - (long)ta * (ta - 1) / 2 + (tb - ta);
  const size_t off = (size_t)tile * TM * TM + (lo % TM) * TM + hi % TM;
  double sum = 0.0;
  for (int sl = 0; sl < n_slices; ++sl)
    sum += part[(size_t)sl * n_tiles * TM * TM + off];
  D[e] = (double)hp[0] * sum;
}

template <typename T>
__global__ void __launch_bounds__(NT)
psi1_tiles(const T* __restrict__ mu, const T* __restrict__ s,
           const T* __restrict__ z, const T* __restrict__ hp, int n, int m,
           int q, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zT = reinterpret_cast<T*>(smem_raw);  // [q][PC]
  T* mus = zT + q * PC;                    // [PR][q]
  T* invs = mus + PR * q;                  // [PR][q]  1 / (l^2 + s)
  T* lns = invs + PR * q;                  // [PR]
  T* ell2 = lns + PR;                      // [q]
  T* il2 = ell2 + q;                       // [q]

  const long r0 = (long)blockIdx.x * PR;
  const int c0 = blockIdx.y * PC;
  const int nr = (int)min((long)PR, (long)n - r0);
  const int tid = threadIdx.x;
  for (int e = tid; e < q; e += NT) {
    ell2[e] = hp[1 + e];
    il2[e] = hp[1 + q + e];
  }
  for (int e = tid; e < q * PC; e += NT) {
    const int k = e / PC, c = e % PC;
    zT[e] = c0 + c < m ? z[(size_t)(c0 + c) * q + k] : T(0);
  }
  __syncthreads();
  stage_rows(mu, s, r0, nr, q, T(1), ell2, il2, mus, invs, lns);
  __syncthreads();

  const T sf2 = hp[0];
  for (int e = tid; e < PR * PC; e += NT) {
    const int r = e / PC, c = e % PC;
    if (r >= nr || c0 + c >= m) continue;
    T acc = 0;
    for (int k = 0; k < q; ++k) {
      const T d = mus[r * q + k] - zT[k * PC + c];
      acc = fma_t(d * invs[r * q + k], d, acc);
    }
    out[(size_t)(r0 + r) * m + c0 + c] = sf2 * exp_t(fma_t(T(-0.5), acc, lns[r]));
  }
}

size_t psi2_smem(int q, size_t item) {
  return item * (2 * (size_t)q * TM + 2 * RC * (size_t)q + 2 * RC + 2 * (size_t)q);
}

size_t psi1_smem(int q, size_t item) {
  return item * ((size_t)q * PC + 2 * PR * (size_t)q + PR + 2 * (size_t)q);
}

template <typename T>
int launch_psi2(const T* mu, const T* s, const T* w, const T* z, const T* hp,
                int n, int m, int q, int n_slices, int rows_per_slice,
                T* part, double* D, void* stream) {
  const int nts = (m + TM - 1) / TM;
  const int n_tiles = nts * (nts + 1) / 2;
  const size_t smem = psi2_smem(q, sizeof(T));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      psi2_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  psi2_tiles<T><<<dim3(n_slices, n_tiles), NT, smem, st>>>(
      mu, s, w, z, hp, n, m, q, rows_per_slice, nts, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)m * m;
  psi2_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, hp, n_slices, nts, m, D);
  return cudaGetLastError();
}

template <typename T>
int launch_psi1(const T* mu, const T* s, const T* z, const T* hp, int n,
                int m, int q, T* out, void* stream) {
  const size_t smem = psi1_smem(q, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      psi1_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + PR - 1) / PR), (unsigned)((m + PC - 1) / PC));
  psi1_tiles<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      mu, s, z, hp, n, m, q, out);
  return cudaGetLastError();
}

}  // namespace

// psi2: mu, s (n,q), w (n,), z (m,q), hp = [sf2^2, l^2 (q), 1/l^2 (q)]:
// contiguous, one dtype, n >= 1.  Scratch part (n_slices, T, 64, 64) in
// that dtype with T = nts(nts+1)/2, nts = ceil(m/64).  Output D (m,m) f64.
// psi1: mu, s (n,q), z (m,q), hp = [sf2, l^2 (q), 1/l^2 (q)]; output
// (n,m) in the inputs' dtype.  Each returns cudaGetLastError().
extern "C" int psi2_f32(const float* mu, const float* s, const float* w,
                        const float* z, const float* hp, int n, int m, int q,
                        int n_slices, int rows_per_slice, float* part,
                        double* D, void* stream) {
  return launch_psi2<float>(mu, s, w, z, hp, n, m, q, n_slices,
                            rows_per_slice, part, D, stream);
}

extern "C" int psi2_f64(const double* mu, const double* s, const double* w,
                        const double* z, const double* hp, int n, int m, int q,
                        int n_slices, int rows_per_slice, double* part,
                        double* D, void* stream) {
  return launch_psi2<double>(mu, s, w, z, hp, n, m, q, n_slices,
                             rows_per_slice, part, D, stream);
}

extern "C" int psi1_f32(const float* mu, const float* s, const float* z,
                        const float* hp, int n, int m, int q, float* out,
                        void* stream) {
  return launch_psi1<float>(mu, s, z, hp, n, m, q, out, stream);
}

extern "C" int psi1_f64(const double* mu, const double* s, const double* z,
                        const double* hp, int n, int m, int q, double* out,
                        void* stream) {
  return launch_psi1<double>(mu, s, z, hp, n, m, q, out, stream);
}
