// Backward of psi1 for Hopper (sm_90a): the vector-Jacobian product of
//
//     P[i, j] = sf2 prod_q (1 + s_iq / l_q^2)^-1/2
//               exp(-1/2 sum_q (mu_iq - z_jq)^2 / (l_q^2 + s_iq))      (n, m)
//
// for the cotangent g (n, m).  With E = g . P, a_iq = 1 / (l_q^2 + s_iq)
// and r = mu_iq - z_jq (per feature):
//
//     d log_sf2   = sum E
//     d z_jq      = sum_i E_ij r a_iq
//     d mu_iq     = -sum_j E_ij r a_iq                          (when asked)
//     d s_iq      = 1/2 sum_j E_ij (r^2 a_iq^2 - a_iq)          (when asked)
//     d log_ell_q = sum_ij E_ij (s_iq a_iq + l_q^2 r^2 a_iq^2)
//
// (kernels/psi_stats/ref.py::psi1_vjp_ref states the same function).
//
// Replaces psi1's gradient.  The TPU kernel psi1_pallas
// (src/repro/kernels/psi_stats/kernel.py:125) has no VJP: the JAX package
// differentiates se_psi1 (src/repro/core/gp_kernels.py:97) through XLA;
// the port recomputed the plain version under autograd in row chunks.
//
// What bounds it on the H100: bytes.  It reads g (n, m) once (5.6 MB f64
// at gplvm-usps) against ~10q + 4 flops and one exp an entry; at
// gplvm-usps the work is microseconds and the launch dominates.  The
// design:
//   * Units of `rows` rows, a multiple of 8 up to P1R = 32, sized by the
//     plan so that the units fill the blocks in flight (two an SM while
//     the E tile fits twice) in one wave where n allows; blocks walk them
//     grid-stride.  A unit takes every column, in tiles of up to P1C = 256
//     (all of m <= 256 in one).  Per tile the block forms E once, in
//     shared memory: the exponent in the direct form (the forward's), one
//     exp (f64 the forward's branch-free exp_pair, f32 one ex2.approx),
//     times g, read once and coalesced.  Then, feature by feature (no
//     per-feature registers: two blocks an SM fit the register file)
//       - by rows: 8 threads a row, each every 8th column, sum E, E r and
//         E r^2 over the tile; a butterfly over the 8 adds them in a fixed
//         order, and the row's lane adds them, tile after tile, into the
//         unit's row sums in shared memory.  The row outputs follow, d mu =
//         -a sum E r and d s = a (a sum E r^2 - sum E) / 2, written by the
//         block that owns the row; the rows' terms of d log_ell and
//         d log_sf2 are added in row order into the block's partials;
//       - by columns: a thread a column sums E r a over the unit's rows and
//         adds it into the block's partial of d z.
//     The E tile's row stride is 8 mod 16 elements, so the row pass's
//     loads (4 rows x 8 columns a warp) hit distinct banks.
//   * The blocks' partials (f64, one scratch allocation) are summed over
//     the blocks in a fixed order by a second kernel, 8 warps an output
//     tile.  No atomics: bitwise repeatable.
//   * Any n, m and q: features are taken QC = 16 at a time in the row and
//     column passes (one pass for q <= 16, every config of the repo; past
//     that E is formed again for each chunk).  With q <= 16 (STAGED) the
//     rows' mu, s, a and the tile's z are staged in shared memory; past it
//     they are read from device memory (L1), the slow but general path.
//     Rows past n and columns past m are never read or written.
//   * The hyper-parameters are read as the log values the caller holds
//     (l^2 = exp(2 log_ell), sf2 = exp(log_sf2) on the card), as the
//     forward reads them.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/psi_stats/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int P1R = 32;   // rows per unit, at most
constexpr int P1C = 256;  // columns per tile
constexpr int QC = 16;    // features a pass
constexpr int QP = QC + 1;  // staged row stride (odd: no conflicts)
constexpr int RP = NT / P1R;  // threads a row in the row pass

// 2^(j/32), j = 0..31, as hi + lo (psi_stats.cu's table).
__constant__ double kExp2Frac[64] = {
    0x1.0000000000000p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f090p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e4540p+0,
    0x0.0p+0, 0x1.d73e2a475b465p-55, 0x1.8a62e4adc610bp-54, -0x1.6c51039449b3ap-54,
    -0x1.19041b9d78a76p-55, 0x1.e016e00a2643cp-54, 0x1.9b07eb6c70573p-54, 0x1.612e8afad1255p-55,
    0x1.6f46ad23182e4p-55, -0x1.63aeabf42eae2p-54, 0x1.ada0911f09ebcp-55, 0x1.89b7a04ef80d0p-59,
    0x1.d4397afec42e2p-56, -0x1.07abe1db13cadp-55, 0x1.6324c054647adp-54, -0x1.383c17e40b497p-54,
    -0x1.bdd3413b26456p-54, -0x1.16e4786887a99p-55, -0x1.41577ee04992fp-55, -0x1.d4c1dd41532d8p-54,
    0x1.6e9f156864b27p-54, -0x1.75fc781b57ebcp-57, 0x1.c7c46b071f2bep-56, -0x1.d2f6edb8d41e1p-54,
    0x1.7a1cd345dcc81p-54, -0x1.5584f7e54ac3bp-56, 0x1.11065895048ddp-55, 0x1.503cbd1e949dbp-56,
    0x1.2ed02d75b3707p-55, -0x1.1a5cd4f184b5cp-54, -0x1.e9c23179c2893p-54, 0x1.9d3e12dd8a18bp-54};

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }

// e^x for an exponent x <= 0 (but for rounding).  f64: psi_stats.cu's
// branch-free exp_pair (its error one rounding beyond a 4e-18
// polynomial), the table tab staged in shared memory.  f32: one
// ex2.approx of x log2(e).
__device__ __forceinline__ double exp_pair(double x, const double* tab) {
  constexpr double kShift = 0x1.8p+52;
  constexpr double kInvLn2_32 = 0x1.71547652b82fep+5;
  constexpr double kLn2_32Hi = 0x1.62e42fef00000p-6;
  constexpr double kLn2_32Lo = 0x1.473de6af278edp-39;
  x = x < -750.0 ? -750.0 : x;
  const double t = fma(x, kInvLn2_32, kShift);
  const int n = __double2loint(t);
  const double nd = t - kShift;
  double r = fma(nd, -kLn2_32Hi, x);
  r = fma(nd, -kLn2_32Lo, r);
  double p = fma(r, 1.0 / 720, 1.0 / 120);
  p = fma(p, r, 1.0 / 24);
  p = fma(p, r, 1.0 / 6);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  const double hi = tab[n & 31], lo = tab[32 + (n & 31)];
  const double e = hi + fma(hi, p * r, lo);
  const int m = n >> 5, m1 = m >> 1;
  return e * __hiloint2double((m1 + 1023) << 20, 0)
           * __hiloint2double((m - m1 + 1023) << 20, 0);
}
__device__ __forceinline__ float exp_pair(float x, const double*) {
  float r;
  const float v = x * 1.44269504088896340736f;  // log2(e)
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
// Sum over the RP = 8 consecutive lanes of a row, in a fixed order; every
// lane of the 8 ends with the same value.
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int o = 1; o < RP; o <<= 1) v += shfl_xor(v, o);
  return v;
}

// Row stride of the E tile for nc <= P1C columns: at least nc, 8 mod 16.
__host__ __device__ constexpr int etl(int nc) { return (nc + 7) / 16 * 16 + 8; }

// Shared memory of one block, in elements: the E tile, z of a tile, the
// rows' mu, s and a, l^2 (STAGED); the log-normalisers, the rows' terms and
// the rows' sums of E, E r and E r^2.
__host__ __device__ constexpr int smem_elems(int m, bool staged) {
  return P1R * etl(m < P1C ? m : P1C)
         + (staged ? (m < P1C ? m : P1C) * QP + 3 * P1R * QP + QC : 0)
         + P1R + P1R * QP + P1R + 2 * P1R * QP;
}

// Blocks walk units of `rows` rows, unit blk, blk + gridDim.x, ...
// Partials (f64) of this block: part_z (m, q), part_ell (q), part_sf2 (1).
// flags: 1 d mu, 2 d s.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT, 2)
psi1b_tiles(const T* __restrict__ mu, const T* __restrict__ s,
            const T* __restrict__ z, const T* __restrict__ log_sf2,
            const T* __restrict__ log_ell, const T* __restrict__ g, int n,
            int m, int q, int rows, int flags, double* __restrict__ part_z,
            double* __restrict__ part_ell, double* __restrict__ part_sf2,
            T* __restrict__ dmu, T* __restrict__ ds) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e2f[64];
  const int ncmax = m < P1C ? m : P1C;
  const int ld = etl(ncmax);
  T* et = reinterpret_cast<T*>(smem_raw);         // [P1R][ld]    E of a tile
  T* zs = et + P1R * ld;                           // [ncmax][QP]  z of a tile
  T* mus = zs + (STAGED ? ncmax * QP : 0);         // [P1R][QP]    mu
  T* ss = mus + (STAGED ? P1R * QP : 0);           // [P1R][QP]    s
  T* as = ss + (STAGED ? P1R * QP : 0);            // [P1R][QP]    1 / (l^2 + s)
  T* l2s = as + (STAGED ? P1R * QP : 0);           // [QC]         l^2
  T* lns = l2s + (STAGED ? QC : 0);                // [P1R]        log-normaliser
  T* rowv = lns + P1R;                             // [P1R][QP]    the rows' terms
  T* rs0 = rowv + P1R * QP;                        // [P1R]        sum E
  T* rs1 = rs0 + P1R;                              // [P1R][QP]    sum E r
  T* rs2 = rs1 + P1R * QP;                         // [P1R][QP]    sum E r^2

  const int tid = threadIdx.x, blk = blockIdx.x;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const T sf2 = exp_t(log_sf2[0]);
  double* pz = part_z + (size_t)blk * m * q;
  for (long e = tid; e < (long)m * q; e += NT) pz[e] = 0.0;
  for (int e = tid; e < q; e += NT) part_ell[(size_t)blk * q + e] = 0.0;
  if (tid == 0) part_sf2[blk] = 0.0;
  if (STAGED)
    for (int f = tid; f < q; f += NT) l2s[f] = exp_t(T(2) * log_ell[f]);

  auto l2f = [&](int f) -> T { return STAGED ? l2s[f] : exp_t(T(2) * log_ell[f]); };
  auto muv = [&](long r0, int i, int f) -> T {
    return STAGED ? mus[i * QP + f] : mu[(size_t)(r0 + i) * q + f];
  };
  auto sv = [&](long r0, int i, int f) -> T {
    return STAGED ? ss[i * QP + f] : s[(size_t)(r0 + i) * q + f];
  };
  auto av = [&](long r0, int i, int f) -> T {
    return STAGED ? as[i * QP + f] : T(1) / (l2f(f) + s[(size_t)(r0 + i) * q + f]);
  };
  auto zv = [&](int c0, int j, int f) -> T {
    return STAGED ? zs[j * QP + f] : z[(size_t)(c0 + j) * q + f];
  };

  const int ri = tid / RP, rp = tid % RP;  // row pass: row ri, columns rp + 8k
  const long n_units = ((long)n + rows - 1) / rows;
  for (long unit = blk; unit < n_units; unit += gridDim.x) {
    const long r0 = unit * rows;
    const int nr = (int)min((long)rows, (long)n - r0);
    const bool rok = ri < nr;
    __syncthreads();  // the previous unit is done with the staged rows
    if (STAGED)
      for (int e = tid; e < nr * q; e += NT) {
        const int i = e / q, f = e % q;
        const size_t o = (size_t)(r0 + i) * q + f;
        const T sv_ = s[o];
        mus[i * QP + f] = mu[o];
        ss[i * QP + f] = sv_;
        as[i * QP + f] = T(1) / (l2s[f] + sv_);
      }
    __syncthreads();
    if (tid < nr) {  // each row's log-normaliser, in feature order
      T acc = T(0);
      for (int f = 0; f < q; ++f) acc += log1p_t(sv(r0, tid, f) / l2f(f));
      lns[tid] = T(-0.5) * acc;
    }
    for (int f0 = 0; f0 < q; f0 += QC) {
      const int fw = min(QC, q - f0);
      for (int c0 = 0; c0 < m; c0 += P1C) {
        const int nc = min(P1C, m - c0);
        __syncthreads();  // the last tile's passes are done with et and zs
        if (STAGED)
          for (int e = tid; e < nc * q; e += NT) {
            const int j = e / q, f = e % q;
            zs[j * QP + f] = z[(size_t)(c0 + j) * q + f];
          }
        __syncthreads();
        // E = g psi1 of the tile; the thread's items tid + k NT as (row,
        // column), stepped without a division per item
        {
          int i = tid / nc, j = tid % nc;
          const int si = NT / nc, sj = NT % nc;
#pragma unroll 4
          for (int e = tid; e < nr * nc; e += NT) {
            T ex = T(0);
            if (STAGED) {
#pragma unroll
              for (int f = 0; f < QC; ++f)
                if (f < q) {
                  const T dv = mus[i * QP + f] - zs[j * QP + f];
                  ex = fma(dv * as[i * QP + f], dv, ex);
                }
            } else {
              for (int f = 0; f < q; ++f) {
                const T dv = muv(r0, i, f) - zv(c0, j, f);
                ex = fma(dv * av(r0, i, f), dv, ex);
              }
            }
            const T p = sf2 * exp_pair(fma(T(-0.5), ex, lns[i]), e2f);
            et[i * ld + j] = g[(size_t)(r0 + i) * m + c0 + j] * p;
            j += sj;
            i += si + (j >= nc);
            j -= j >= nc ? nc : 0;
          }
        }
        __syncthreads();
        // by rows, feature by feature: the 8 lanes of a row sum their
        // columns, a butterfly adds them, the row's lane adds the tile's
        // sums into the unit's (every lane shuffles: rows past nr add 0)
        if (f0 == 0) {
          T s0 = T(0);
          if (rok)
            for (int j = rp; j < nc; j += RP) s0 += et[ri * ld + j];
          s0 = row_sum(s0);
          if (rp == 0 && rok) rs0[ri] = c0 == 0 ? s0 : rs0[ri] + s0;
        }
        for (int f = 0; f < fw; ++f) {
          T t1 = T(0), t2 = T(0);
          if (rok) {
            const T mv = muv(r0, ri, f0 + f);
            for (int j = rp; j < nc; j += RP) {
              const T dv = mv - zv(c0, j, f0 + f);
              const T t = et[ri * ld + j] * dv;
              t1 += t;
              t2 = fma(t, dv, t2);
            }
          }
          t1 = row_sum(t1);
          t2 = row_sum(t2);
          if (rp == 0 && rok) {
            rs1[ri * QP + f] = c0 == 0 ? t1 : rs1[ri * QP + f] + t1;
            rs2[ri * QP + f] = c0 == 0 ? t2 : rs2[ri * QP + f] + t2;
          }
        }
        // by columns: sum_i E r a into the block's partial of d z
        for (int j = tid; j < nc; j += NT)
          for (int f = 0; f < fw; ++f) {
            const T zj = zv(c0, j, f0 + f);
            T dz = T(0);
            for (int i = 0; i < nr; ++i) {
              const T dv = muv(r0, i, f0 + f) - zj;
              dz = fma(et[i * ld + j] * dv, av(r0, i, f0 + f), dz);
            }
            pz[(size_t)(c0 + j) * q + f0 + f] += (double)dz;
          }
      }
      __syncthreads();  // the rows' sums
      // the row outputs and the rows' terms, a thread a (row, feature)
      for (int e = tid; e < nr * fw; e += NT) {
        const int i = e / fw, f = e % fw;
        const size_t row = (size_t)(r0 + i);
        const T a = av(r0, i, f0 + f), a0 = rs0[i], a2 = rs2[i * QP + f];
        if (flags & 1) dmu[row * q + f0 + f] = -a * rs1[i * QP + f];
        if (flags & 2) ds[row * q + f0 + f] = T(0.5) * a * fma(a, a2, -a0);
        rowv[i * QP + f] = sv(r0, i, f0 + f) * a * a0 + l2f(f0 + f) * a * a * a2;
      }
      if (f0 == 0)
        for (int i = tid; i < nr; i += NT) rowv[i * QP + QC] = rs0[i];
      __syncthreads();
      if (tid < fw) {  // d log_ell's rows' terms, in row order
        double acc = 0.0;
        for (int i = 0; i < nr; ++i) acc += (double)rowv[i * QP + tid];
        part_ell[(size_t)blk * q + f0 + tid] += acc;
      }
      if (tid == QC && f0 == 0) {
        double acc = 0.0;
        for (int i = 0; i < nr; ++i) acc += (double)rowv[i * QP + QC];
        part_sf2[blk] += acc;
      }
    }
  }
}

// Fixed-order f64 sums of the blocks' partials: a block sums 32
// consecutive outputs (of d z, then d log_ell, then d log_sf2), its warp w
// the partials w, w + 8, ..., then warp 0 adds the 8 warps' sums in order.
__global__ void psi1b_reduce(const double* __restrict__ part_z,
                             const double* __restrict__ part_ell,
                             const double* __restrict__ part_sf2,
                             int n_blocks, int m, int q,
                             double* __restrict__ dz, double* __restrict__ dell,
                             double* __restrict__ dsf2) {
  __shared__ double sh[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long e = (long)blockIdx.x * 32 + lane;
  const long mq = (long)m * q, total = mq + q + 1;
  const double* src = e < mq ? part_z + e : e < mq + q ? part_ell + (e - mq) : part_sf2;
  const long stride = e < mq ? mq : e < mq + q ? q : 1;
  double acc = 0.0;
  if (e < total) {
#pragma unroll 4
    for (int b = w; b < n_blocks; b += 8) acc += src[(size_t)b * stride];
  }
  sh[w][lane] = acc;
  __syncthreads();
  if (w == 0 && e < total) {
    double t = 0.0;
    for (int k = 0; k < 8; ++k) t += sh[k][lane];
    if (e < mq) dz[e] = t;
    else if (e < mq + q) dell[e - mq] = t;
    else *dsf2 = t;
  }
}

template <typename T>
int launch(const T* mu, const T* s, const T* z, const T* log_sf2,
           const T* log_ell, const T* g, int n, int m, int q, int n_blocks,
           int rows, int flags, double* scratch, double* dz, double* dell,
           double* dsf2, T* dmu, T* ds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool staged = q <= QC;
  auto kernel = staged ? psi1b_tiles<T, true> : psi1b_tiles<T, false>;
  // The attribute once per device and variant, at the largest tile: a
  // runtime call per launch costs host time the card waits for.
  static bool ready[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][staged]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(smem_elems(P1C, staged) * sizeof(T)));
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][staged] = true;
  }
  double* part_z = scratch;
  double* part_ell = part_z + (size_t)n_blocks * m * q;
  double* part_sf2 = part_ell + (size_t)n_blocks * q;
  kernel<<<(unsigned)n_blocks, NT, smem_elems(m, staged) * sizeof(T), st>>>(
      mu, s, z, log_sf2, log_ell, g, n, m, q, rows, flags, part_z, part_ell,
      part_sf2, dmu, ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)m * q + q + 1;
  psi1b_reduce<<<(unsigned)((total + 31) / 32), 256, 0, st>>>(
      part_z, part_ell, part_sf2, n_blocks, m, q, dz, dell, dsf2);
  return cudaGetLastError();
}

static_assert(smem_elems(P1C, true) * sizeof(double) <= 232448 - 512,
              "f64 block over sm_90's 227 KB beside the exp table");

}  // namespace

// mu, s (n, q), z (m, q), log_sf2 (), log_ell (q,), g (n, m): contiguous,
// one dtype.  n_blocks blocks (at least one) walk the units of `rows` rows
// (a multiple of 8, at most 32).  scratch (f64): part_z (n_blocks, m, q),
// part_ell (n_blocks, q), part_sf2 (n_blocks).  Outputs (f64): dz (m, q),
// dell (q), dsf2 (); when flags asks (1, 2), dmu and ds (n, q) in the input
// dtype.  Any n, m and q.  Returns cudaGetLastError().
extern "C" int psi1_bwd_f64(const double* mu, const double* s, const double* z,
                            const double* log_sf2, const double* log_ell,
                            const double* g, int n, int m, int q, int n_blocks,
                            int rows, int flags, double* scratch, double* dz,
                            double* dell, double* dsf2, double* dmu, double* ds,
                            void* stream) {
  return launch<double>(mu, s, z, log_sf2, log_ell, g, n, m, q, n_blocks, rows,
                        flags, scratch, dz, dell, dsf2, dmu, ds, stream);
}

extern "C" int psi1_bwd_f32(const float* mu, const float* s, const float* z,
                            const float* log_sf2, const float* log_ell,
                            const float* g, int n, int m, int q, int n_blocks,
                            int rows, int flags, double* scratch, double* dz,
                            double* dell, double* dsf2, float* dmu, float* ds,
                            void* stream) {
  return launch<float>(mu, s, z, log_sf2, log_ell, g, n, m, q, n_blocks, rows,
                       flags, scratch, dz, dell, dsf2, dmu, ds, stream);
}
