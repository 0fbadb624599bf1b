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
//   * Shared memory is fixed, whatever q: z, mu and 1/(l^2 + c s) are
//     staged QC = 16 features at a time and the exponents accumulate over
//     the chunks (psi1's in the entries' registers; psi2's in registers
//     per row, z and the row restaged chunk by chunk).  gplvm-usps
//     (q = 10) is one chunk, staged as before.
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
constexpr int QC = 16;   // features of z, mu and 1/(l^2 + c s) staged at a time

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

// Stage rows [r0, r0 + nr) of q(X), features [k0, k0 + kw): mu and
// 1/(l^2 + c s) (c = 2 for psi2, 1 for psi1) into row slots [slot,
// slot + nr) of mus/invs (row stride QC).  hp = [., l^2 (q), 1/l^2 (q)].
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ mu,
                                           const T* __restrict__ s,
                                           const T* __restrict__ hp, int q,
                                           long r0, int nr, int k0, int kw,
                                           T c, int slot, T* mus, T* invs) {
  for (int e = threadIdx.x; e < nr * kw; e += blockDim.x) {
    const int r = e / kw, k = e % kw;
    const long g = (r0 + r) * q + k0 + k;
    mus[(slot + r) * QC + k] = mu[g];
    invs[(slot + r) * QC + k] = T(1) / fma_t(c, s[g], hp[1 + k0 + k]);
  }
}

// The log-normaliser -1/2 sum_q log1p(c s / l^2) of rows [r0, r0 + nr),
// over all q, read from device memory.
template <typename T>
__device__ __forceinline__ void stage_lognorm(const T* __restrict__ s,
                                              const T* __restrict__ hp, int q,
                                              long r0, int nr, T c, T* lns) {
  const T* il2 = hp + 1 + q;
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
  T* haT = reinterpret_cast<T*>(smem_raw);  // [QC][TM]  z_a / 2
  T* hbT = haT + QC * TM;                   // [QC][TM]  z_b / 2
  T* mus = hbT + QC * TM;                   // [RC][QC]
  T* invs = mus + RC * QC;                  // [RC][QC]  1 / (l^2 + 2 s)
  T* lns = invs + RC * QC;                  // [RC]      log-normaliser
  T* ws = lns + RC;                         // [RC]
  T* il2 = ws + RC;                         // [QC]      1 / l^2

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
  // q > QC: z and each row's mu and 1/(l^2 + 2s) are staged a q-chunk at a
  // time for every row, the exponent carried across the chunks in
  // registers.  Otherwise z stays staged and rows are staged RC at a time.
  const bool chunked = q > QC;

  // z_a/2, z_b/2 and 1/l^2 of features [k0, k0 + kw)
  auto stage_z = [&](int k0, int kw) {
    for (int e = tid; e < kw; e += NT) il2[e] = hp[1 + q + k0 + e];
    for (int e = tid; e < kw * TM; e += NT) {
      const int k = e / TM, i = e % TM;
      haT[e] = a0 + i < m ? T(0.5) * z[(size_t)(a0 + i) * q + k0 + k] : T(0);
      hbT[e] = b0 + i < m ? T(0.5) * z[(size_t)(b0 + i) * q + k0 + k] : T(0);
    }
  };

  // static_ab = -(z_a - z_b)^2 / (4 l^2) = -(z_a/2 - z_b/2)^2 / l^2
  T st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[i][j] = T(0);
  for (int k0 = 0; k0 < q; k0 += QC) {
    const int kw = min(QC, q - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk is consumed
    stage_z(k0, kw);
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
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
    if (!chunked) stage_rows(mu, s, hp, q, r0, nr, 0, q, T(2), 0, mus, invs);
    stage_lognorm(s, hp, q, r0, nr, T(2), lns);
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
      for (int k0 = 0; k0 < q; k0 += QC) {
        const int kw = min(QC, q - k0);
        if (chunked) {
          __syncthreads();  // the staged chunk is consumed
          stage_z(k0, kw);
          stage_rows(mu, s, hp, q, r0 + r, 1, k0, kw, T(2), r, mus, invs);
          __syncthreads();
        }
        for (int k = 0; k < kw; ++k) {
          const T mv = mus[r * QC + k], iv = invs[r * QC + k];
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
  T* zT = reinterpret_cast<T*>(smem_raw);  // [QC][PC]
  T* mus = zT + QC * PC;                   // [PR][QC]
  T* invs = mus + PR * QC;                 // [PR][QC]  1 / (l^2 + s)
  T* lns = invs + PR * QC;                 // [PR]

  const long r0 = (long)blockIdx.x * PR;
  const int c0 = blockIdx.y * PC;
  const int nr = (int)min((long)PR, (long)n - r0);
  const int tid = threadIdx.x;
  stage_lognorm(s, hp, q, r0, nr, T(1), lns);

  // Each thread owns PER output entries; their exponents accumulate over
  // q-chunks of z, mu and 1/(l^2 + s).
  constexpr int PER = PR * PC / NT;
  T acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = T(0);
  for (int k0 = 0; k0 < q; k0 += QC) {
    const int kw = min(QC, q - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < kw * PC; e += NT) {
      const int k = e / PC, c = e % PC;
      zT[e] = c0 + c < m ? z[(size_t)(c0 + c) * q + k0 + k] : T(0);
    }
    stage_rows(mu, s, hp, q, r0, nr, k0, kw, T(1), 0, mus, invs);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * NT, r = e / PC, c = e % PC;
      if (r >= nr) continue;
      for (int k = 0; k < kw; ++k) {
        const T d = mus[r * QC + k] - zT[k * PC + c];
        acc[u] = fma_t(d * invs[r * QC + k], d, acc[u]);
      }
    }
  }

  const T sf2 = hp[0];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * NT, r = e / PC, c = e % PC;
    if (r >= nr || c0 + c >= m) continue;
    out[(size_t)(r0 + r) * m + c0 + c] = sf2 * exp_t(fma_t(T(-0.5), acc[u], lns[r]));
  }
}

// Shared memory of one block, whatever q.
size_t psi2_smem(size_t item) {
  return item * (2 * QC * TM + 2 * RC * QC + 2 * RC + QC);
}

size_t psi1_smem(size_t item) {
  return item * (QC * PC + 2 * PR * QC + PR);
}

template <typename T>
int launch_psi2(const T* mu, const T* s, const T* w, const T* z, const T* hp,
                int n, int m, int q, int n_slices, int rows_per_slice,
                T* part, double* D, void* stream) {
  const int nts = (m + TM - 1) / TM;
  const int n_tiles = nts * (nts + 1) / 2;
  const size_t smem = psi2_smem(sizeof(T));
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
  const size_t smem = psi1_smem(sizeof(T));
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
