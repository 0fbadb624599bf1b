// Backward of the weighted psi2 statistic for Hopper (sm_90a): the
// vector-Jacobian product of
//
//     D[j, k] = sum_n w_n psi_n[j, k],
//     psi_n[j, k] = sf2^2 prod_q (1 + 2 s_nq / l_q^2)^-1/2
//                   exp(-(z_jq - z_kq)^2 / (4 l_q^2) - r^2 / (l_q^2 + 2 s_nq)),
//     r = mu_nq - (z_jq + z_kq) / 2   (summed over q in the exponent),
//
// for the cotangent g (m, m).  With F_njk = w_n g_jk psi_n[j, k] and
// D_nq = l_q^2 + 2 s_nq:
//
//     d mu_nq     = -2 sum_jk F r / D
//     d s_nq      = sum_jk F (2 r^2 / D^2 - 1 / D)
//     d z_jq      = sum_nk (F_njk + F_nkj) (r / D - (z_jq - z_kq) / (2 l_q^2))
//     d log_ell_q = 2 l_q^2 sum F (s / (l_q^2 D) + (z_jq - z_kq)^2 / (4 l_q^4)
//                                  + r^2 / D^2)
//     d log_sf2   = 2 sum F
//     d w_n       = sum_jk g_jk psi_n[j, k]
//
// (kernels/psi_stats/ref.py::psi2_vjp_ref states the same function).
//
// Replaces the backward of the TPU kernel's custom_vjp,
// src/repro/kernels/psi_stats/ops.py:56 (jax.vjp of gp_kernels.psi2_mxu,
// the recompute through XLA); the port recomputed the plain version under
// autograd in row chunks.
//
// What bounds it on the H100: operations, O(n m^2 q) like the forward: per
// (row, pair) the exponent (q features), one exp and, per feature, the
// products of F with r and r^2.  The design:
//   * Only the pairs the forward walks: psi_n is symmetric, so the pair
//     (j < k) carries g_jk + g_kj and the diagonal g_jj, walked as the
//     forward's upper 4 x 4 patches of 64 x 64 tiles (kernels/psi_stats.cu).
//   * A block owns a slice of rows and walks every tile for them, so the
//     per-row sums (sum F, sum g psi, and per feature sum F r and sum F r^2)
//     are owned by the block: each row's are summed over the block's
//     threads (a warp butterfly, then the warps in order) and added into
//     its row accumulators in device memory, tile after tile.  The row
//     outputs and the rows' parts of d log_ell and d log_sf2 follow from
//     those sums (D, s) in a second pass.
//   * The per-point sums of d z (sum over rows and partners of F r / D)
//     are kept in registers per thread, for its patch's 4 + 4 points and
//     QB = 4 features at a time: the features go in passes over the rows,
//     the exponent recomputed in each (q = 10 takes three).  After a pass
//     the threads' sums, with the static term (sum over rows of F, per
//     pair, times (z_j - z_k) / (2 l^2)), go through shared memory and
//     are added point by point over the threads that hold the point, in a
//     fixed order.
//   * Every sum has a fixed order and an owner: the rows' accumulators and
//     the slices' partials of d z and d log_ell (f64) are summed in a
//     fixed order by the last kernel.  No atomics: bitwise repeatable.
//   * The exponent and r in the direct form (r itself, never expanded in
//     mu^2 or z^2), exp as the forward's (f64: its branch-free exp_pair).
//   * Ragged edges: z comes zero-padded to a multiple of 64 rows; pairs
//     past m or below the diagonal carry a zero cotangent, so they add
//     exactly zero, and their points are never written.
//   * Shared memory is fixed: with q <= QC = 16 (STAGED, every config of
//     the repo) z, mu and 1/D are staged in shared memory; past that they
//     are read from device memory (L1), the slow but general path.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/psi_stats/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // tile edge (the forward's)
constexpr int PP = 4;    // patch edge
constexpr int RC = 32;   // rows staged per chunk
constexpr int NT = 256;  // threads per block
constexpr int QC = 16;   // features staged
constexpr int QB = 4;    // features a pass
constexpr int NV = 2 * QB + 2;  // a row's sums: F r (QB), F r^2 (QB), F, g psi

// 2^(j/32), j = 0..31, as hi + lo (the forward's table, psi_stats.cu).
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

// The forward's exp (psi_stats.cu::exp_pair): f64 branch-free, f32 expf.
__device__ __forceinline__ float exp_pair(float x, const double*) { return expf(x); }
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

__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int patch_index(int pa, int pb, int np) {
  return pa * np - pa * (pa - 1) / 2 + (pb - pa);
}

// Per row: the log-normaliser -1/2 sum_q log1p(2 s / l^2) and 1/D =
// 1/(l^2 + 2 s).  hp = [sf2^2, l^2 (q)].
template <typename T>
__global__ void psi2b_rows(const T* __restrict__ s, const T* __restrict__ hp,
                           int n, int q, T* __restrict__ lns,
                           T* __restrict__ ivs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int k = 0; k < q; ++k) {
    const T sk = s[i * q + k];
    acc += log1p_t(T(2) * sk / hp[1 + k]);
    ivs[i * q + k] = T(1) / (hp[1 + k] + T(2) * sk);
  }
  lns[i] = T(-0.5) * acc;
}

// One block: rows [slice * rows_per_slice, ...) against every upper tile.
// racc (n, 2 + 2q), f64: per row sum F, sum g psi, then per feature
// sum F 2r and sum F (2r)^2.  part_z (slices, mp, q) and part_ell
// (slices, q), f64: the slice's sums of d z and of d log_ell's static
// term.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(NT, 1)
psi2b_tiles(const T* __restrict__ mu, const T* __restrict__ w,
            const T* __restrict__ zp, const T* __restrict__ g,
            const T* __restrict__ hp, const T* __restrict__ lns_g,
            const T* __restrict__ ivs_g, int n, int m, int q, int nts,
            int rows_per_slice, double* __restrict__ racc,
            double* __restrict__ part_z, double* __restrict__ part_ell) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e2f[64];
  T* za = reinterpret_cast<T*>(smem_raw);  // [QC][TM]
  T* zb = za + QC * TM;                    // [QC][TM]
  T* mus = zb + QC * TM;                   // [RC][QC]
  T* ivs = mus + RC * QC;                  // [RC][QC]
  T* lns = ivs + RC * QC;                  // [RC]
  T* ws = lns + RC;                        // [RC]
  T* rred = ws + RC;                       // [RC][NV][8]  warps' row sums
  T* pbuf = rred + RC * NV * 8;            // [2 PP][QB][NT] threads' point sums
  T* wred = pbuf + 2 * PP * QB * NT;       // [QB][8]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int slice = blockIdx.x;
  const int mp = nts * TM;
  const int rw = 2 + 2 * q;
  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  const T sf4 = hp[0];
  for (long e = tid; e < (hi - lo) * rw; e += NT) racc[lo * rw + e] = 0.0;
  double* pz = part_z + (size_t)slice * mp * q;
  for (int e = tid; e < mp * q; e += NT) pz[e] = 0.0;
  if (tid < q) part_ell[(size_t)slice * q + tid] = 0.0;
  if (hi <= lo) return;

  const int n_tiles = nts * (nts + 1) / 2;
  for (int tile = 0; tile < n_tiles; ++tile) {
    int ta = 0, rem = tile;
    while (rem >= nts - ta) {
      rem -= nts - ta;
      ++ta;
    }
    const int tb = ta + rem;
    const bool diag = ta == tb;
    const int a0 = ta * TM, b0 = tb * TM;
    const int na = min(TM / PP, (m - a0 + PP - 1) / PP);
    const int nb = min(TM / PP, (m - b0 + PP - 1) / PP);
    const int count = diag ? na * (na + 1) / 2 : na * nb;
    const bool active = tid < count;
    int pa = 0, pb = 0;
    if (active && diag) {
      int r = tid;
      while (r >= na - pa) {
        r -= na - pa;
        ++pa;
      }
      pb = pa + r;
    } else if (active) {
      pa = tid / nb;
      pb = tid % nb;
    }
    const int ia = a0 + pa * PP, ib = b0 + pb * PP;  // the patch's first points

    __syncthreads();  // the last tile's staged z and sums are consumed
    if (STAGED)
      for (int e = tid; e < q * TM; e += NT) {
        const int f = e / TM, p = e % TM;
        za[f * TM + p] = zp[(size_t)(a0 + p) * q + f];
        zb[f * TM + p] = zp[(size_t)(b0 + p) * q + f];
      }
    // The pairs' cotangent with sf2^2 exp(static): zero for pairs the patch
    // does not own (below the diagonal, past m, an idle thread).
    T gst[PP][PP], fsum[PP][PP];
#pragma unroll
    for (int i = 0; i < PP; ++i)
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int a = ia + i, b = ib + j;
        fsum[i][j] = T(0);
        gst[i][j] = T(0);
        if (active && a <= b && b < m) {
          T st = T(0);
          for (int f = 0; f < q; ++f) {
            const T dz = zp[(size_t)a * q + f] - zp[(size_t)b * q + f];
            st += dz * dz / hp[1 + f];
          }
          const T gs = a == b ? g[(size_t)a * m + a]
                              : g[(size_t)a * m + b] + g[(size_t)b * m + a];
          gst[i][j] = sf4 * gs * exp_pair(T(-0.25) * st, e2f);
        }
      }
    __syncthreads();  // staged z

    auto zav = [&](int f, T (&v)[PP]) {
#pragma unroll
      for (int i = 0; i < PP; ++i)
        v[i] = STAGED ? za[f * TM + pa * PP + i] : zp[(size_t)(ia + i) * q + f];
    };
    auto zbv = [&](int f, T (&v)[PP]) {
#pragma unroll
      for (int j = 0; j < PP; ++j)
        v[j] = STAGED ? zb[f * TM + pb * PP + j] : zp[(size_t)(ib + j) * q + f];
    };

    for (int qb = 0; qb < q; qb += QB) {
      T sa[PP][QB], sb[PP][QB];  // sum over rows of (sum over partners F 2r) / D
#pragma unroll
      for (int i = 0; i < PP; ++i)
#pragma unroll
        for (int v = 0; v < QB; ++v) sa[i][v] = sb[i][v] = T(0);

      for (long r0 = lo; r0 < hi; r0 += RC) {
        const int nr = (int)min((long)RC, hi - r0);
        __syncthreads();  // the last chunk's rows and row sums are consumed
        for (int r = tid; r < nr; r += NT) {
          ws[r] = w[r0 + r];
          lns[r] = lns_g[r0 + r];
        }
        if (STAGED)
          for (int e = tid; e < nr * q; e += NT) {
            const int r = e / q, f = e % q;
            mus[r * QC + f] = mu[(r0 + r) * q + f];
            ivs[r * QC + f] = ivs_g[(r0 + r) * q + f];
          }
        __syncthreads();
        auto muv = [&](int r, int f) -> T {
          return STAGED ? mus[r * QC + f] : mu[(r0 + r) * q + f];
        };
        auto ivv = [&](int r, int f) -> T {
          return STAGED ? ivs[r * QC + f] : ivs_g[(r0 + r) * q + f];
        };

        for (int r = 0; r < nr; ++r) {
          const T wr = ws[r];
          // the exponent, direct form: -sum_q (2r)^2 / (4 D)
          T e[PP][PP];
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < PP; ++j) e[i][j] = lns[r];
          for (int f = 0; f < q; ++f) {
            const T mv = muv(r, f), iv4 = T(-0.25) * ivv(r, f);
            T zz[PP], ua[PP], ub[PP];
            zav(f, zz);
#pragma unroll
            for (int i = 0; i < PP; ++i) ua[i] = mv - zz[i];
            zbv(f, zz);
#pragma unroll
            for (int j = 0; j < PP; ++j) ub[j] = mv - zz[j];
#pragma unroll
            for (int i = 0; i < PP; ++i)
#pragma unroll
              for (int j = 0; j < PP; ++j) {
                const T r2 = ua[i] + ub[j];
                e[i][j] = fma(r2 * r2, iv4, e[i][j]);
              }
          }
          T fv[PP][PP], s0 = T(0), sw = T(0);
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < PP; ++j) {
              const T p = gst[i][j] * exp_pair(e[i][j], e2f);
              fv[i][j] = wr * p;
              sw += p;
              s0 += fv[i][j];
              if (qb == 0) fsum[i][j] += fv[i][j];
            }
          T s1[QB], s2[QB];
#pragma unroll
          for (int v = 0; v < QB; ++v) {
            s1[v] = s2[v] = T(0);
            const int f = qb + v;
            if (f < q) {
              const T mv = muv(r, f), iv = ivv(r, f);
              T zz[PP], ua[PP], ub[PP], ra[PP], rb[PP];
              zav(f, zz);
#pragma unroll
              for (int i = 0; i < PP; ++i) {
                ua[i] = mv - zz[i];
                ra[i] = T(0);
              }
              zbv(f, zz);
#pragma unroll
              for (int j = 0; j < PP; ++j) {
                ub[j] = mv - zz[j];
                rb[j] = T(0);
              }
#pragma unroll
              for (int i = 0; i < PP; ++i)
#pragma unroll
                for (int j = 0; j < PP; ++j) {
                  const T r2 = ua[i] + ub[j];
                  const T t = fv[i][j] * r2;
                  s1[v] += t;
                  s2[v] = fma(t, r2, s2[v]);
                  ra[i] += t;
                  rb[j] += t;
                }
#pragma unroll
              for (int i = 0; i < PP; ++i) {
                sa[i][v] = fma(ra[i], iv, sa[i][v]);
                sb[i][v] = fma(rb[i], iv, sb[i][v]);
              }
            }
          }
          // the row's sums over the block: a butterfly, the warps in order
#pragma unroll
          for (int v = 0; v < QB; ++v) {
            const T x1 = warp_sum(s1[v]), x2 = warp_sum(s2[v]);
            if (lane == 0) {
              rred[(r * NV + v) * 8 + warp] = x1;
              rred[(r * NV + QB + v) * 8 + warp] = x2;
            }
          }
          if (qb == 0) {
            const T x0 = warp_sum(s0), xw = warp_sum(sw);
            if (lane == 0) {
              rred[(r * NV + 2 * QB) * 8 + warp] = x0;
              rred[(r * NV + 2 * QB + 1) * 8 + warp] = xw;
            }
          }
        }
        __syncthreads();  // every row's warp sums
        for (int e = tid; e < nr * NV; e += NT) {
          const int r = e / NV, v = e % NV;
          int slot;
          if (v < QB) slot = qb + v < q ? 2 + qb + v : -1;
          else if (v < 2 * QB) slot = qb + v - QB < q ? 2 + q + qb + v - QB : -1;
          else slot = qb == 0 ? v - 2 * QB : -1;
          if (slot < 0) continue;
          T s = T(0);
          for (int k = 0; k < 8; ++k) s += rred[(r * NV + v) * 8 + k];
          racc[(r0 + r) * rw + slot] += (double)s;
        }
      }

      // The pass's point sums: F r / D over rows and partners (half of the
      // sums of F 2r) and the static term, per point and feature.
#pragma unroll
      for (int v = 0; v < QB; ++v) {
        const int f = qb + v;
        T dl = T(0);
        T ca[PP], cb[PP];
#pragma unroll
        for (int i = 0; i < PP; ++i) ca[i] = cb[i] = T(0);
        if (f < q) {
          const T h = T(0.5) / hp[1 + f];  // 1 / (2 l^2)
          T zx[PP], zy[PP];
          zav(f, zx);
          zbv(f, zy);
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < PP; ++j) {
              const T dz = zx[i] - zy[j];
              const T t = fsum[i][j] * dz;
              ca[i] += t;
              cb[j] -= t;
              dl = fma(t, dz, dl);
            }
#pragma unroll
          for (int i = 0; i < PP; ++i) {
            ca[i] = T(0.5) * sa[i][v] - ca[i] * h;
            cb[i] = T(0.5) * sb[i][v] - cb[i] * h;
          }
          dl *= h;
        }
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          pbuf[(i * QB + v) * NT + tid] = ca[i];
          pbuf[((PP + i) * QB + v) * NT + tid] = cb[i];
        }
        const T x = warp_sum(dl);
        if (lane == 0) wred[v * 8 + warp] = x;
      }
      __syncthreads();
      for (int e = tid; e < (diag ? 1 : 2) * TM * QB; e += NT) {
        const int side = e / (TM * QB), p = (e % (TM * QB)) / QB, v = e % QB;
        const int f = qb + v, pp = p / PP, ii = p % PP;
        const int point = (side == 0 ? a0 : b0) + p;
        if (f >= q || point >= m) continue;
        T s = T(0);
        if (side == 0) {
          // as the first point of its pairs: the patches (pp, pb')
          for (int pb2 = diag ? pp : 0; pb2 < nb; ++pb2)
            s += pbuf[(ii * QB + v) * NT + (diag ? patch_index(pp, pb2, na) : pp * nb + pb2)];
          if (diag)  // and as the second: the patches (pa', pp)
            for (int pa2 = 0; pa2 <= pp; ++pa2)
              s += pbuf[((PP + ii) * QB + v) * NT + patch_index(pa2, pp, na)];
        } else {
          for (int pa2 = 0; pa2 < na; ++pa2)
            s += pbuf[((PP + ii) * QB + v) * NT + pa2 * nb + pp];
        }
        pz[(size_t)point * q + f] += (double)s;
      }
      if (tid < QB && qb + tid < q) {
        T s = T(0);
        for (int k = 0; k < 8; ++k) s += wred[tid * 8 + k];
        part_ell[(size_t)slice * q + qb + tid] += (double)s;
      }
      __syncthreads();  // pbuf and wred are free
    }
  }
}

// Row outputs from the rows' sums (flags: 1 d mu, 2 d s, 4 d w).
template <typename T>
__global__ void psi2b_rows_out(const double* __restrict__ racc,
                               const T* __restrict__ ivs, int n, int q,
                               int flags, T* __restrict__ dmu,
                               T* __restrict__ ds, T* __restrict__ dw) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double* ra = racc + i * (2 + 2 * q);
  if (flags & 4) dw[i] = (T)ra[1];
  for (int f = 0; f < q; ++f) {
    const double iv = ivs[i * q + f];
    if (flags & 1) dmu[i * q + f] = (T)(-ra[2 + f] * iv);
    if (flags & 2) ds[i * q + f] = (T)((0.5 * ra[2 + q + f] * iv - ra[0]) * iv);
  }
}

// Fixed-order sums: blocks [0, q) d log_ell (the rows' terms, then the
// slices' static terms), block q d log_sf2, the rest d z.
template <typename T>
__global__ void psi2b_reduce(const double* __restrict__ racc,
                             const T* __restrict__ s, const T* __restrict__ ivs,
                             const T* __restrict__ hp,
                             const double* __restrict__ part_z,
                             const double* __restrict__ part_ell, int n_slices,
                             int n, int m, int q, int mp,
                             double* __restrict__ dz, double* __restrict__ dell,
                             double* __restrict__ dsf2) {
  __shared__ double sh[256];
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int rw = 2 + 2 * q;
  if (blk <= q) {
    double acc = 0.0;
    for (long i = tid; i < n; i += blockDim.x) {
      const double* ra = racc + i * rw;
      if (blk == q) {
        acc += 2.0 * ra[0];
      } else {
        const double iv = ivs[i * q + blk], l2 = hp[1 + blk];
        acc += 2.0 * ra[0] * (double)s[i * q + blk] * iv
               + 0.5 * l2 * ra[2 + q + blk] * iv * iv;
      }
    }
    sh[tid] = acc;
    __syncthreads();
    for (int o = 128; o > 0; o >>= 1) {
      if (tid < o) sh[tid] += sh[tid + o];
      __syncthreads();
    }
    if (tid == 0) {
      if (blk == q) {
        *dsf2 = sh[0];
      } else {
        double t = sh[0];
        for (int sl = 0; sl < n_slices; ++sl) t += part_ell[(size_t)sl * q + blk];
        dell[blk] = t;
      }
    }
    return;
  }
  const long e = (long)(blk - q - 1) * blockDim.x + tid;
  if (e < (long)m * q) {
    double t = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) t += part_z[(size_t)sl * mp * q + e];
    dz[e] = t;
  }
}

constexpr size_t smem_elems() {
  return 2 * QC * TM + 2 * RC * QC + 2 * RC + RC * NV * 8 + 2 * PP * QB * NT + QB * 8;
}

template <typename T>
int launch(const T* mu, const T* s, const T* w, const T* zp, const T* g,
           const T* hp, int n, int m, int q, int n_slices, int rows_per_slice,
           int flags, T* lns, T* ivs, double* racc, double* part_z,
           double* part_ell, double* dz, double* dell, double* dsf2, T* dmu,
           T* ds, T* dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nts = (m + TM - 1) / TM, mp = nts * TM;
  const bool staged = q <= QC;
  const int smem = (int)(smem_elems() * sizeof(T));
  auto kernel = staged ? psi2b_tiles<T, true> : psi2b_tiles<T, false>;
  static bool ready[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][staged]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][staged] = true;
  }
  if (n > 0) psi2b_rows<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(s, hp, n, q, lns, ivs);
  kernel<<<(unsigned)n_slices, NT, smem, st>>>(mu, w, zp, g, hp, lns, ivs, n, m, q,
                                               nts, rows_per_slice, racc, part_z,
                                               part_ell);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0 && (flags & 7))
    psi2b_rows_out<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(racc, ivs, n, q, flags,
                                                                   dmu, ds, dw);
  const long mq = (long)m * q;
  psi2b_reduce<T><<<(unsigned)(q + 1 + (mq + 255) / 256), 256, 0, st>>>(
      racc, s, ivs, hp, part_z, part_ell, n_slices, n, m, q, mp, dz, dell, dsf2);
  return cudaGetLastError();
}

static_assert(smem_elems() * sizeof(double) <= 232448 - 512, "f64 block over sm_90's 227 KB");

}  // namespace

// mu, s (n, q), w (n,): the forward's inputs.  zp (mp, q): z zero-padded to
// mp = 64 ceil(m / 64).  g (m, m): the cotangent.  hp = [sf2^2, l^2 (q)].
// One block per slice of rows_per_slice rows (n_slices of them).  Scratch:
// lns (n), ivs (n, q) in the input dtype; racc (n, 2 + 2q), part_z
// (n_slices, mp, q), part_ell (n_slices, q) in f64.  Outputs (f64): dz (m,
// q), dell (q), dsf2 (); when flags asks (1, 2, 4), dmu, ds (n, q) and dw
// (n) in the input dtype.  Any q: shared memory is fixed.  Returns
// cudaGetLastError().
extern "C" int psi2_bwd_f64(const double* mu, const double* s, const double* w,
                            const double* zp, const double* g, const double* hp,
                            int n, int m, int q, int n_slices, int rows_per_slice,
                            int flags, double* lns, double* ivs, double* racc,
                            double* part_z, double* part_ell, double* dz,
                            double* dell, double* dsf2, double* dmu, double* ds,
                            double* dw, void* stream) {
  return launch<double>(mu, s, w, zp, g, hp, n, m, q, n_slices, rows_per_slice,
                        flags, lns, ivs, racc, part_z, part_ell, dz, dell, dsf2,
                        dmu, ds, dw, stream);
}

extern "C" int psi2_bwd_f32(const float* mu, const float* s, const float* w,
                            const float* zp, const float* g, const float* hp,
                            int n, int m, int q, int n_slices, int rows_per_slice,
                            int flags, float* lns, float* ivs, double* racc,
                            double* part_z, double* part_ell, double* dz,
                            double* dell, double* dsf2, float* dmu, float* ds,
                            float* dw, void* stream) {
  return launch<float>(mu, s, w, zp, g, hp, n, m, q, n_slices, rows_per_slice,
                       flags, lns, ivs, racc, part_z, part_ell, dz, dell, dsf2,
                       dmu, ds, dw, stream);
}
