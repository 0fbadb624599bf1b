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
// psi2_pallas (body _psi2_kernel, :76) and psi1_pallas (body _psi1_kernel,
// :125), forward only (the wrapper's autograd.Function recomputes the
// plain version for the backward, as the JAX custom_vjp does).
//
// What bounds them on the H100:
//   * psi2: operations, and of those the exps.  Each (row, pair a <= b)
//     costs one exp and, in the centred form below, q FMAs and a few adds:
//     at gplvm-usps (n = 4649, m = 150, q = 10) 5.3e7 exps against ~0.9 MB
//     of input.  In f32 the exp runs on the SFU (16 a clock per SM); in
//     f64 it is ~12 f64 ops on the CUDA cores (exp_pair), so the exps and
//     the FP64 pipe set the pace.
//   * psi1: bytes (it writes the (n, m) output once: 5.6 MB f64 at
//     gplvm-usps, 80 MB at gplvm-synth-100k, against 3q flops and one exp
//     per entry), and at gplvm-usps the launch itself: the work is a few
//     microseconds.
//
// The psi2 design (both dtypes; the f32 kernel's differences below):
//   * Only the pairs D needs.  The TPU accumulates D over a sequential
//     n-grid; blocks on Hopper run in parallel in no order, and gplvm-usps
//     has only 6 upper 64x64 tiles of D for 132 SMs.  So the work is units
//     of (upper tile, slice of rows), on gridDim.x (walked grid-stride, so
//     no m is refused), about 8 per SM.  Inside a tile each thread owns a
//     4x4 patch of pairs, and only the patches holding a pair a <= b < m
//     are given out: a diagonal tile's triangle, a ragged tile's points
//     below m.  At m = 150 that evaluates 11,856 pairs for D's 11,325
//     (64x64 tiles evaluated 24,576).  Where a tile's patches fill at most
//     half the block, its threads split into groups that take every
//     groups-th row, their sums added in group order.
//   * The exponent in a centred form.  With u_a = mu_i - z_a and
//     c = l^2 + 2 s_i (per feature),
//         -sum_q (mu_i - zbar_ab)^2 / c
//             = alpha_ia + alpha_ib + sum_q u_a (z_b - mu_i) / (2c),
//         alpha_ia = -sum_q u_a^2 / (4c):
//     one FMA per pair and feature (the direct form takes three).  The
//     alphas of a tile's points are computed once per staged row; a thread
//     makes u for its 4 a points and (z_b - mu)/(2c) for its 4 b points on
//     the fly.  The terms are no larger than the exponent itself: per
//     feature |alpha_a| + |alpha_b| + |cross| <= (u_a^2 + u_b^2) / (2c),
//     while the whole exponent, static part included, is at least that
//     large ((u_a + u_b)^2 / (4c) + (u_a - u_b)^2 / (4 l^2), c >= l^2).  So
//     the form's error is a few ulp of the exponent, as the direct form's,
//     and since exp underflows past 745 that is < 1e-13 relative to each
//     term.  (The Pallas body's expansion in mu^2/c has terms unbounded by
//     the exponent, so it cancels.)
//   * exp(static_ab), static_ab = -(z_a - z_b)^2 / (4 l^2), does not depend
//     on the row: the reduce applies it, in f64, once per pair.  The rows'
//     log-normalisers and 1/(2c) are computed once per row (psi2_rows),
//     not once per tile.
//   * The f64 exp is branch-free (exp_pair), so a thread's 16 exps
//     interleave.
//   * What bounds the pair loop beside the exps is shared memory: per pair
//     row and feature a thread loads 8 z values and the row's mu and
//     1/(2c), 80 bytes for 16 FMAs, where an SM delivers 128 bytes a clock
//     against 64 f64 FMAs.  z cannot stay in registers across rows (4 + 4
//     points x 16 features) beside the 32 accumulators.
//   * A second kernel sums the slice partials in a fixed order (slice 0,
//     1, ...) in f64, so D is deterministic; one thread per pair a <= b
//     writes D[a, b] and D[b, a], so D is exactly symmetric.  No atomics.
//   * Ragged edges are masked, never padded into a result: rows past the
//     slice are not visited, zero-weight rows are skipped, inducing points
//     past m carry z = 0 and are never written.  q is a loop bound.
//   * Shared memory is fixed, whatever q: z, mu and 1/(2c) are staged
//     QC = 16 features at a time; past one chunk the exponents accumulate
//     in registers over the chunks, z and the row restaged chunk by chunk.
//
// The psi1 design:
//   * One launch, the hyper-parameters read as the log values the caller
//     holds (l^2 = exp(2 log_ell), sf2 = exp(log_sf2) on the card): the
//     wrapper builds no tensor and launches nothing else.
//   * Units sized to m: a unit is up to P1R rows by up to P1C columns,
//     the columns of a row cut into runs of 16 bytes (2 f64, 4 f32); the
//     plan (kernel.py::psi1_plan) takes all of m <= 256 in one unit and as
//     many rows as give each thread up to P1I (row, run) items, so each
//     row's log-normaliser and 1/(l^2 + s) are computed once, not once per
//     64-column tile (gplvm-usps: 13 rows x 150 columns, 358 units).
//   * A warp takes consecutive runs of a row: its z loads are conflict-free
//     16-byte vectors of the transposed tile, mu and 1/(l^2 + s) are
//     broadcasts, and its stores are coalesced 16-byte vectors wherever the
//     row stride m keeps the runs aligned (scalar stores otherwise).  z is
//     read in rows (coalesced) and transposed in shared memory.
//   * The exponent in the direct form, sum_q (mu - z)^2 / (l^2 + s), whose
//     terms are bounded by the exponent (the Pallas body's expansion in
//     mu^2/c, z^2/c is not; see the psi2 notes).  The bound is bytes, so a
//     cheaper form would buy nothing.
//   * The f64 exp is psi2's branch-free exp_pair; f32 takes expf.
//   * Shared memory is bounded (psi1_smem, under the 48 KB default; less
//     for q < 16, so more blocks fit an SM) and q is staged 16 features at
//     a time, the exponents carried in registers.
//     Rows past n and columns past m are never written.
//
// psi1 is one template, instantiated for float (the TPU kernels' f32
// contract) and double; so is psi2's f64 path.  f32 map statistics break the
// q(u) factorisation at full width (ROADMAP Queue 3), so f64 callers get the
// double instantiations, and no main path launches the f32 ones.
//
// psi2 f32 is a kernel of its own (psi2_f32_tiles, psi2_f32_reduce): the
// f64 design's reasons for four launches, the branch-free exp and per-pair
// u and v do not hold in f32, where the exp is one SFU instruction.
//   * Two launches: each unit stages its rows' 1/(2c) and log-normaliser
//     (rounded as the plain version rounds them) itself; psi2_hyper and
//     psi2_rows ran before the tile pass.
//   * The exponent in log2 units (log2(e) folded into 1/(2c) and the
//     log-normaliser) and one ex2.approx a pair, not libdevice's expf.
//   * u_a = mu - z_a and v_b = (z_b - mu) log2(e) / (2c) staged once per
//     row and tile point, so a pair row costs per feature two float4 loads
//     and 16 FMAs.
//   * The f64 plan (about 8 units an SM): units of 2 or 4 an SM measured
//     slower, the small tiles' units finishing early.  The sums stay in
//     registers across a unit's rows; the partials are laid out
//     entry-major, so the reduce's loads coalesce.
// What bounds it on the H100 (ablations at gplvm-usps, PERF.md section 6):
// not the SFU (the exps cost 3%), but the pair loop's shared-memory loads
// (two float4 a feature for 16 FMAs) and, as much again, each unit's
// staging and barriers; z held in registers instead cost occupancy and
// measured no faster.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/psi_stats/kernel.py.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int TM = 64;   // psi2 D tile edge
constexpr int PP = 4;    // psi2 patch edge: a thread's PP x PP pairs
constexpr int RC = 32;   // psi2 rows staged per chunk
constexpr int NT = 256;  // threads per block
constexpr int QC = 16;   // features of z, mu and 1/(l^2 + c s) staged at a time
constexpr int P1R = 32;  // psi1 rows per unit, at most
constexpr int P1C = 256; // psi1 columns per unit, at most
constexpr int P1I = 4;   // psi1 (row, run) items per thread, at most
constexpr int RLD = QC + 1;  // psi1 staged row stride: no bank conflicts

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// 2^(j/32), j = 0..31, as hi + lo: hi rounded to nearest, lo the rest.
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

// psi2's and psi1's exp of an exponent (at most 0 but for rounding).  f32:
// expf.
// f64: branch-free, so a thread's 16 exps interleave (libdevice's exp
// branches on its range, which serialises them): x = (32 m + j) ln2/32 + r
// with |r| <= ln2/64, e^r by its Taylor polynomial to r^6 (truncation
// 4e-18 relative), 2^(j/32) as hi + lo from the table tab (kExp2Frac
// staged in shared memory), 2^m as two exact power-of-two factors, so
// results below 2^-1022 underflow gradually and x < -750 gives 0; NaN stays
// NaN.  Error: one rounding of the result beyond the polynomial's ~1e-16.
// It must not err to one side: D sums thousands of these terms, and the
// GPLVM's ill-conditioned bound turns a bias of half an ulp (a shorter
// polynomial's truncation, or the table's rounding of 2^(j/32) taken once
// per j) into a gradient shift near its tolerance.
__device__ __forceinline__ float exp_pair(float x, const double*) { return expf(x); }
__device__ __forceinline__ double exp_pair(double x, const double* tab) {
  constexpr double kShift = 0x1.8p+52;                 // rounds to an integer
  constexpr double kInvLn2_32 = 0x1.71547652b82fep+5;  // 32 / ln 2
  constexpr double kLn2_32Hi = 0x1.62e42fef00000p-6;   // ln 2 / 32, 33 bits
  constexpr double kLn2_32Lo = 0x1.473de6af278edp-39;  // the rest
  x = x < -750.0 ? -750.0 : x;
  const double t = fma(x, kInvLn2_32, kShift);
  const int n = __double2loint(t);                     // round(x 32 / ln 2)
  const double nd = t - kShift;
  double r = fma(nd, -kLn2_32Hi, x);
  r = fma(nd, -kLn2_32Lo, r);
  double p = fma(r, 1.0 / 720, 1.0 / 120);
  p = fma(p, r, 1.0 / 24);
  p = fma(p, r, 1.0 / 6);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);                                  // (e^r - 1) / r
  const double hi = tab[n & 31], lo = tab[32 + (n & 31)];
  const double e = hi + fma(hi, p * r, lo);            // 2^(j/32) e^r
  const int m = n >> 5, m1 = m >> 1;                   // m >= -1083
  return e * __hiloint2double((m1 + 1023) << 20, 0)
           * __hiloint2double((m - m1 + 1023) << 20, 0);
}

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

// One 16-byte vector of shared memory into registers, and of registers
// out to device memory (both 16-byte aligned).
__device__ __forceinline__ void loadv(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void loadv(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void storev(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void storev(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// The upper-triangle patch (pa, pb), pa <= pb < np, as one index: the
// patches of row pa follow those of rows 0 .. pa-1.
__host__ __device__ __forceinline__ long patch_index(long pa, long pb, long np) {
  return pa * np - pa * (pa - 1) / 2 + (pb - pa);
}

// hp = [sf2^2, l^2 (q)] from the log hyper-parameters.
template <typename T>
__global__ void psi2_hyper(const T* __restrict__ log_sf2,
                           const T* __restrict__ log_ell, int q,
                           T* __restrict__ hp) {
  for (int k = threadIdx.x; k < q; k += blockDim.x)
    hp[1 + k] = exp_t(T(2) * log_ell[k]);
  if (threadIdx.x == 0) {
    const T sf2 = exp_t(log_sf2[0]);
    hp[0] = sf2 * sf2;
  }
}

// Per row, once for every tile: the log-normaliser -1/2 sum_q log1p(2 s /
// l^2) into lns (n) and 1/(2 (l^2 + 2 s)) into ivs (n, q).  sf2^2, the
// log-normalisers and the static part are rounded as the plain version
// rounds them (sf2 * sf2, divisions by l^2): an offset of an ulp there is
// shared by every term of D and does not average out.
template <typename T>
__global__ void psi2_rows(const T* __restrict__ s, const T* __restrict__ hp,
                          int n, int q, T* __restrict__ lns,
                          T* __restrict__ ivs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T acc = T(0);
  for (int k = 0; k < q; ++k) {
    const T sk = s[i * q + k];
    acc += log1p_t(T(2) * sk / hp[1 + k]);
    ivs[i * q + k] = T(1) / fma_t(T(4), sk, T(2) * hp[1 + k]);
  }
  lns[i] = T(-0.5) * acc;
}

// One unit of work: the upper patches of one TM x TM tile of D over one
// slice of rows.  Each active thread owns a PP x PP patch of pairs and
// accumulates, per row i,
//     w_i exp(lognorm_i + alpha_ia + alpha_ib + sum_q u_a (z_b - mu) / (2c))
// with u_a = mu_i - z_a, c = l^2 + 2 s_i and
// alpha_ia = -sum_q u_a^2 / (4c); exp(static_ab) is applied by the reduce.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
psi2_tiles(const T* __restrict__ mu, const T* __restrict__ w,
           const T* __restrict__ z, const T* __restrict__ lns_g,
           const T* __restrict__ ivs_g, int n, int m, int q, int nts,
           int n_slices, int rows_per_slice, T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e2f[64];
  T* za = reinterpret_cast<T*>(smem_raw);  // [QC][TM]  z of the a tile's points
  T* zb = za + QC * TM;                    // [QC][TM]  z of the b tile's points
  T* aa = zb + QC * TM;                    // [RC][TM]  alpha of a points (+ lognorm)
  T* ab = aa + RC * TM;                    // [RC][TM]  alpha of b points
  T* tot = ab + RC * TM;                   // [PP*PP][NT]  each thread's sums
  T* mus = tot + PP * PP * NT;             // [RC][QC]
  T* ivs = mus + RC * QC;                  // [RC][QC]  1 / (2 (l^2 + 2 s))
  T* lns = ivs + RC * QC;                  // [RC]      log-normaliser
  T* ws = lns + RC;                        // [RC]

  const int tid = threadIdx.x;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int np = (m + PP - 1) / PP;
  const long n_patches = (long)np * (np + 1) / 2;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  // q > QC: z and each row's mu and 1/(2c) are staged a q-chunk at a time
  // for every row, the exponent carried across the chunks in registers.
  // Otherwise z stays staged and rows are staged RC at a time.
  const bool chunked = q > QC;

  for (long unit = blockIdx.x; unit < n_tiles * n_slices; unit += gridDim.x) {
    const long tile = unit % n_tiles;
    const int slice = (int)(unit / n_tiles);
    int ta = 0;
    long rem = tile;
    while (rem >= nts - ta) {
      rem -= nts - ta;
      ++ta;
    }
    const int tb = ta + (int)rem;
    const int a0 = ta * TM, b0 = tb * TM;
    // The tile's patches that hold a pair a <= b < m, packed onto threads:
    // a diagonal tile's triangle, a ragged tile's points below m.  When
    // they fill at most half the block, the block splits into `groups`
    // of `count` threads, each taking every groups-th row.
    const int na = min(TM / PP, (m - a0 + PP - 1) / PP);
    const int nb = min(TM / PP, (m - b0 + PP - 1) / PP);
    const int count = ta == tb ? na * (na + 1) / 2 : na * nb;
    const int groups = chunked ? 1 : max(1, NT / count);
    const int grp = tid / count, lt = tid % count;
    const bool active = grp < groups;
    int pa = 0, pb;
    if (ta == tb) {
      int r = lt;
      while (r >= na - pa) {
        r -= na - pa;
        ++pa;
      }
      pb = pa + r;
    } else {
      pa = lt / nb;
      pb = lt % nb;
    }

    // z of both tiles, features [k0, k0 + kw); points past m carry 0
    auto stage_z = [&](int k0, int kw) {
      for (int e = tid; e < kw * TM; e += NT) {
        const int k = e / TM, i = e % TM;
        za[e] = a0 + i < m ? z[(size_t)(a0 + i) * q + k0 + k] : T(0);
        zb[e] = b0 + i < m ? z[(size_t)(b0 + i) * q + k0 + k] : T(0);
      }
    };
    // mu and 1/(2c) of rows [r0, r0 + nr), features [k0, k0 + kw)
    auto stage_rows = [&](long r0, int nr, int k0, int kw) {
      for (int e = tid; e < nr * kw; e += NT) {
        const int r = e / kw, k = e % kw;
        const long g = (r0 + r) * q + k0 + k;
        mus[r * QC + k] = mu[g];
        ivs[r * QC + k] = ivs_g[g];
      }
    };
    // alpha of every point of both tiles for staged rows [0, nr) over the
    // staged features [0, kw); the a side also carries ln[r] when given
    auto stage_alpha = [&](int nr, int kw, const T* ln) {
      for (int e = tid; e < nr * 2 * TM; e += NT) {
        const int r = e / (2 * TM), p = e % (2 * TM);
        const T* zc = p < TM ? za + p : zb + (p - TM);
        T acc = T(0);
        for (int k = 0; k < kw; ++k) {
          const T u = mus[r * QC + k] - zc[k * TM];
          acc = fma_t(u * ivs[r * QC + k], u, acc);
        }
        if (p < TM)
          aa[r * TM + p] = fma_t(T(-0.5), acc, ln ? ln[r] : T(0));
        else
          ab[r * TM + p - TM] = T(-0.5) * acc;
      }
    };

#pragma unroll
    for (int e = 0; e < PP * PP; ++e) tot[e * NT + tid] = T(0);
    if (!chunked) stage_z(0, q);
    const long lo = (long)slice * rows_per_slice;
    const long hi = min((long)n, lo + rows_per_slice);
    for (long r0 = lo; r0 < hi; r0 += RC) {
      const int nr = (int)min((long)RC, hi - r0);
      __syncthreads();  // the previous chunk's rows are consumed
      for (int r = tid; r < nr; r += NT) {
        ws[r] = w[r0 + r];
        lns[r] = lns_g[r0 + r];
      }
      if (!chunked) {
        stage_rows(r0, nr, 0, q);
        __syncthreads();
        stage_alpha(nr, q, lns);
      }
      __syncthreads();

      T acc[PP][PP];
#pragma unroll
      for (int i = 0; i < PP; ++i)
#pragma unroll
        for (int j = 0; j < PP; ++j) acc[i][j] = T(0);
      const int r_first = chunked ? 0 : (active ? grp : nr);
      const int r_step = chunked ? 1 : groups;
      for (int r = r_first; r < nr; r += r_step) {
        const T wr = ws[r];
        // masked rows cost nothing (block-uniform when chunked)
        if (wr == T(0)) continue;
        const int rs = chunked ? 0 : r;  // the row's staged slot
        T e[PP][PP];
        for (int k0 = 0; k0 < q; k0 += QC) {
          const int kw = min(QC, q - k0);
          if (chunked) {
            __syncthreads();  // the staged chunk is consumed
            stage_z(k0, kw);
            stage_rows(r0 + r, 1, k0, kw);
            __syncthreads();
            stage_alpha(1, kw, k0 == 0 ? lns + r : nullptr);
            __syncthreads();
          }
          if (!active) continue;
          T av[PP], bv[PP];
          load4(aa + rs * TM + pa * PP, av);
          load4(ab + rs * TM + pb * PP, bv);
          if (k0 == 0) {
#pragma unroll
            for (int i = 0; i < PP; ++i)
#pragma unroll
              for (int j = 0; j < PP; ++j) e[i][j] = av[i] + bv[j];
          } else {
#pragma unroll
            for (int i = 0; i < PP; ++i)
#pragma unroll
              for (int j = 0; j < PP; ++j) e[i][j] += av[i] + bv[j];
          }
          for (int k = 0; k < kw; ++k) {
            const T mv = mus[rs * QC + k], iv = ivs[rs * QC + k];
            T zav[PP], zbv[PP], u[PP], v[PP];
            load4(za + k * TM + pa * PP, zav);
            load4(zb + k * TM + pb * PP, zbv);
#pragma unroll
            for (int i = 0; i < PP; ++i) {
              u[i] = mv - zav[i];            // mu - z_a
              v[i] = (zbv[i] - mv) * iv;     // (z_b - mu) / (2c)
            }
#pragma unroll
            for (int i = 0; i < PP; ++i)
#pragma unroll
              for (int j = 0; j < PP; ++j) e[i][j] = fma_t(u[i], v[j], e[i][j]);
          }
        }
        if (active) {
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < PP; ++j)
              acc[i][j] = fma_t(wr, exp_pair(e[i][j], e2f), acc[i][j]);
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < PP; ++i)
#pragma unroll
          for (int j = 0; j < PP; ++j) tot[(i * PP + j) * NT + tid] += acc[i][j];
      }
    }

    // The groups' sums, added in group order, are this slice's partial.
    __syncthreads();
    if (active && grp == 0) {
      const long ga = a0 / PP + pa, gb = b0 / PP + pb;
      T* pd = part + ((size_t)slice * n_patches + patch_index(ga, gb, np)) * (PP * PP);
#pragma unroll
      for (int e = 0; e < PP * PP; ++e) {
        T sum = tot[e * NT + lt];
        for (int g = 1; g < groups; ++g) sum += tot[e * NT + g * count + lt];
        pd[e] = sum;
      }
    }
    __syncthreads();  // tot and the staged z are free for the next unit
  }
}

// Fixed-order f64 sum of the slice partials, times sf2^2 exp(static_ab)
// with static_ab = -sum_q (z_a - z_b)^2 / (4 l^2) in f64; one thread per
// pair a <= b writes D[a, b] and D[b, a], so D is exactly symmetric.
template <typename T>
__global__ void psi2_reduce(const T* __restrict__ part,
                            const T* __restrict__ z, const T* __restrict__ hp,
                            int n_slices, int m, int q,
                            double* __restrict__ D) {
  const int np = (m + PP - 1) / PP;
  const size_t slice_len = (size_t)((long)np * (np + 1) / 2) * (PP * PP);
  const T* l2 = hp + 1;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < (long)m * m;
       e += (long)gridDim.x * blockDim.x) {
    const int a = (int)(e / m), b = (int)(e % m);
    if (a > b) continue;
    const size_t off = (size_t)patch_index(a / PP, b / PP, np) * (PP * PP)
                       + (a % PP) * PP + b % PP;
    // four running sums (slice sl into sum sl % 4), so four loads are in
    // flight; still one fixed order
    double s4[4] = {0.0, 0.0, 0.0, 0.0};
    int sl = 0;
    for (; sl + 4 <= n_slices; sl += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) s4[u] += (double)part[(sl + u) * slice_len + off];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (sl + u < n_slices) s4[u] += (double)part[(sl + u) * slice_len + off];
    const double sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    double st = 0.0;
    for (int k = 0; k < q; ++k) {
      const double d = (double)z[(size_t)a * q + k] - (double)z[(size_t)b * q + k];
      st += d * d / (double)l2[k];
    }
    const double v = (double)hp[0] * exp(-0.25 * st) * sum;
    D[(size_t)a * m + b] = v;
    D[(size_t)b * m + a] = v;
  }
}

// ---------------------------------------------------------------------------
// psi2, f32
// ---------------------------------------------------------------------------

constexpr int UVE = 16384;  // psi2 f32: floats of the staged rows' u and v

// 2^v on the SFU, one instruction (relative error ~2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

constexpr float kLog2e = 1.44269504088896340736f;

// Shared memory of one psi2 f32 block (floats), whatever q: z of both tiles
// (one q-chunk), the staged rows' u and v (UVE; the threads' sums reuse it
// at the end of a unit), the alphas of the tiles' points, the rows' (mu,
// log2(e)/(2c)) pairs and log1p(2 s / l^2) terms of one q-chunk, their
// log-normalisers and weights.  Two blocks fit an SM.
constexpr int P2F_SMEM_ELEMS = 2 * QC * TM + UVE + 2 * RC * TM + 3 * RC * QC
                               + 2 * RC;
static_assert(PP * PP * NT <= UVE, "the threads' sums reuse the u/v buffer");
static_assert(2 * (P2F_SMEM_ELEMS * sizeof(float) + 1024) <= 233472,
              "two psi2 f32 blocks over an SM's 228 KB");

// The f64 kernel's units, tiles and patches, and its centred exponent,
// with the per-pair work cut to the cross term's FMAs:
//   * each unit stages its rows' log-normaliser and 1/(2c) itself, l^2 =
//     exp(2 log_ell) from the log values (no launch before it);
//   * per staged row, u_a = mu - z_a for the a tile's points and v_b =
//     (z_b - mu) log2(e) / (2c) for the b tile's are staged once, with the
//     alphas, so a thread's pair row costs per feature two float4 loads and
//     16 FMAs (the f64 kernel makes u and v per pair row: 1.75 ops a pair
//     and feature);
//   * the exponent in log2 units (log2(e) folded into 1/(2c) and the
//     log-normaliser) and one ex2.approx a pair;
//   * as many rows staged at a time as UVE holds (12 at q = 10, 32 at q <= 4);
//   * the sums in registers across the unit's rows, written once;
//   * the partials laid out [slice][entry][patch], so the reduce's loads
//     coalesce.
// Points past m are not staged: only their own pairs, which the reduce
// never reads, see the stale values.
__global__ void __launch_bounds__(NT, 2)
psi2_f32_tiles(const float* __restrict__ mu, const float* __restrict__ s,
               const float* __restrict__ w, const float* __restrict__ z,
               const float* __restrict__ log_ell, int n, int m, int q,
               int nts, int n_slices, int rows_per_slice,
               float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* za = reinterpret_cast<float*>(smem_raw);  // [QC][TM]  z of the a tile's points
  float* zb = za + QC * TM;                        // [QC][TM]  z of the b tile's points
  float* uv = zb + QC * TM;                        // u [rows][kw][TM], then v; tot at the end
  float* aa = uv + UVE;                            // [RC][TM]  alpha of a points
  float* ab = aa + RC * TM;                        // [RC][TM]  alpha of b points
  float2* mi = reinterpret_cast<float2*>(ab + RC * TM);  // [RC][QC] (mu, log2(e)/(2c))
  float* lnk = reinterpret_cast<float*>(mi + RC * QC);   // [RC][QC] log1p(2 s / l^2)
  float* lns = lnk + RC * QC;                      // [RC]  log-normaliser, log2 units
  float* ws = lns + RC;                            // [RC]
  float* tot = uv;                                 // [PP*PP][NT]  each thread's sums

  const int tid = threadIdx.x;
  const int np = (m + PP - 1) / PP;
  const long n_patches = (long)np * (np + 1) / 2;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  const bool chunked = q > QC;

  for (long unit = blockIdx.x; unit < n_tiles * n_slices; unit += gridDim.x) {
    const long tile = unit % n_tiles;
    const int slice = (int)(unit / n_tiles);
    int ta = 0;
    long rem = tile;
    while (rem >= nts - ta) {
      rem -= nts - ta;
      ++ta;
    }
    const int tb = ta + (int)rem;
    const int a0 = ta * TM, b0 = tb * TM;
    // The tile's patches that hold a pair a <= b < m, packed onto threads
    // and split into row groups, as in f64.
    const int na = min(TM / PP, (m - a0 + PP - 1) / PP);
    const int nb = min(TM / PP, (m - b0 + PP - 1) / PP);
    const int count = ta == tb ? na * (na + 1) / 2 : na * nb;
    const int groups = chunked ? 1 : max(1, NT / count);
    const int grp = tid / count, lt = tid % count;
    const bool active = grp < groups;
    int pa = 0, pb;
    if (ta == tb) {
      int r = lt;
      while (r >= na - pa) {
        r -= na - pa;
        ++pa;
      }
      pb = pa + r;
    } else {
      pa = lt / nb;
      pb = lt % nb;
    }
    const int pts_a = min(TM, m - a0), pts_b = min(TM, m - b0);

    // z of both tiles, features [k0, k0 + kw)
    auto stage_z = [&](int k0, int kw) {
      for (int e = tid; e < kw * TM; e += NT) {
        const int k = e / TM, i = e % TM;
        if (i < pts_a) za[e] = z[(size_t)(a0 + i) * q + k0 + k];
        if (i < pts_b) zb[e] = z[(size_t)(b0 + i) * q + k0 + k];
      }
    };
    // Rows [r0, r0 + nr), features [k0, k0 + kw): (mu, log2(e)/(2c)) and
    // log1p(2 s / l^2), rounded as the plain version rounds them.
    auto stage_rows = [&](long r0, int nr, int k0, int kw) {
      for (int e = tid; e < nr * kw; e += NT) {
        const int r = e / kw, k = e % kw;
        const size_t g = (size_t)(r0 + r) * q + k0 + k;
        const float sv = s[g], l2 = expf(2.f * log_ell[k0 + k]);
        mi[r * QC + k] = make_float2(mu[g], kLog2e / fmaf(4.f, sv, 2.f * l2));
        lnk[r * QC + k] = log1pf(2.f * sv / l2);
      }
    };
    // For the staged rows: their log-normalisers over the staged features
    // (summed in feature order), u and the a alphas of the a tile's
    // points, v and the b alphas of the b tile's.
    float* const u_st = uv;
    auto stage_uv = [&](int nr, int kw) {
      float* v_st = uv + nr * kw * TM;
      for (int r = tid; r < nr; r += NT) {
        float acc = 0.f;
        for (int k = 0; k < kw; ++k) acc += lnk[r * QC + k];
        lns[r] = kLog2e * (-0.5f * acc);
      }
      for (int e = tid; e < nr * 2 * TM; e += NT) {
        const int r = e / (2 * TM), p = e % (2 * TM);
        float acc = 0.f;
        if (p < TM) {
          if (p >= pts_a) continue;
          for (int k = 0; k < kw; ++k) {
            const float2 v = mi[r * QC + k];
            const float u = v.x - za[k * TM + p];               // mu - z_a
            u_st[(r * kw + k) * TM + p] = u;
            acc = fmaf(u * v.y, u, acc);
          }
          aa[r * TM + p] = -0.5f * acc;
        } else {
          const int i = p - TM;
          if (i >= pts_b) continue;
          for (int k = 0; k < kw; ++k) {
            const float2 v = mi[r * QC + k];
            const float d = zb[k * TM + i] - v.x;               // z_b - mu
            const float vv = d * v.y;
            v_st[(r * kw + k) * TM + i] = vv;
            acc = fmaf(d, vv, acc);
          }
          ab[r * TM + i] = -0.5f * acc;
        }
      }
    };

    // rows staged at a time: all of u and v in UVE (one when chunked)
    const int rows = chunked ? 1 : min(RC, UVE / (2 * TM * max(q, 1)));
    if (!chunked) stage_z(0, q);
    float acc[PP][PP];
#pragma unroll
    for (int i = 0; i < PP; ++i)
#pragma unroll
      for (int j = 0; j < PP; ++j) acc[i][j] = 0.f;
    const long lo = (long)slice * rows_per_slice;
    const long hi = min((long)n, lo + rows_per_slice);
    for (long r0 = lo; r0 < hi; r0 += chunked ? RC : rows) {
      const int nr = (int)min((long)(chunked ? RC : rows), hi - r0);
      __syncthreads();  // the previous rows are consumed
      for (int r = tid; r < nr; r += NT) ws[r] = w[r0 + r];
      if (!chunked) {
        stage_rows(r0, nr, 0, q);
        __syncthreads();
        stage_uv(nr, q);
      }
      __syncthreads();

      const int r_first = chunked ? 0 : (active ? grp : nr);
      const int r_step = chunked ? 1 : groups;
      for (int r = r_first; r < nr; r += r_step) {
        const float wr = ws[r];
        // masked rows cost nothing (block-uniform when chunked)
        if (wr == 0.f) continue;
        const int rs = chunked ? 0 : r;  // the row's staged slot
        float e[PP][PP];
        for (int k0 = 0; k0 < q; k0 += QC) {
          const int kw = min(QC, q - k0);
          if (chunked) {
            __syncthreads();  // the staged chunk is consumed
            stage_z(k0, kw);
            stage_rows(r0 + r, 1, k0, kw);
            __syncthreads();
            stage_uv(1, kw);
            __syncthreads();
          }
          if (!active) continue;
          float av[PP], bv[PP];
          load4(aa + rs * TM + pa * PP, av);
          load4(ab + rs * TM + pb * PP, bv);
          const float ln = lns[rs];
#pragma unroll
          for (int i = 0; i < PP; ++i) {
            const float ai = av[i] + ln;
#pragma unroll
            for (int j = 0; j < PP; ++j)
              e[i][j] = k0 == 0 ? ai + bv[j] : e[i][j] + (ai + bv[j]);
          }
          const int nrs = chunked ? 1 : nr;
          const float* ur = u_st + rs * kw * TM + pa * PP;
          const float* vr = uv + (nrs + rs) * kw * TM + pb * PP;
          for (int k = 0; k < kw; ++k) {
            float uk[PP], vk[PP];
            load4(ur + k * TM, uk);
            load4(vr + k * TM, vk);
#pragma unroll
            for (int i = 0; i < PP; ++i)
#pragma unroll
              for (int j = 0; j < PP; ++j) e[i][j] = fmaf(uk[i], vk[j], e[i][j]);
          }
        }
        if (active) {
#pragma unroll
          for (int i = 0; i < PP; ++i)
#pragma unroll
            for (int j = 0; j < PP; ++j)
              acc[i][j] = fmaf(wr, ex2_approx(e[i][j]), acc[i][j]);
        }
      }
    }

    // The groups' sums, added in group order, are this slice's partial.
    __syncthreads();  // u and v are consumed: tot takes their place
    if (active) {
#pragma unroll
      for (int e = 0; e < PP * PP; ++e) tot[e * NT + tid] = acc[e / PP][e % PP];
    }
    __syncthreads();
    if (active && grp == 0) {
      const long ga = a0 / PP + pa, gb = b0 / PP + pb;
      float* pd = part + (size_t)slice * n_patches * (PP * PP)
                  + patch_index(ga, gb, np);
#pragma unroll
      for (int e = 0; e < PP * PP; ++e) {
        float sum = tot[e * NT + lt];
        for (int g = 1; g < groups; ++g) sum += tot[e * NT + g * count + lt];
        pd[(size_t)e * n_patches] = sum;
      }
    }
  }
}

// Fixed-order f64 sum of the slice partials, times sf2^2 exp(static_ab)
// with static_ab = -sum_q (z_a - z_b)^2 / (4 l^2), sf2 and l^2 from the log
// values in f64.  Thread t takes entry t / np^2 of patch (pa, pb) =
// divmod(t % np^2, np), so consecutive threads read consecutive patches of
// one entry; one thread per pair a <= b writes D[a, b] and D[b, a], so D is
// exactly symmetric.
__global__ void psi2_f32_reduce(const float* __restrict__ part,
                                const float* __restrict__ z,
                                const float* __restrict__ log_sf2,
                                const float* __restrict__ log_ell,
                                int n_slices, int m, int q,
                                double* __restrict__ D) {
  const int np = (m + PP - 1) / PP;
  const long n_patches = (long)np * (np + 1) / 2;
  const size_t slice_len = (size_t)n_patches * (PP * PP);
  const long grid = (long)np * np;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
       t < PP * PP * grid; t += (long)gridDim.x * blockDim.x) {
    const int e = (int)(t / grid);
    const long rem = t % grid;
    const int pa = (int)(rem / np), pb = (int)(rem % np);
    const int a = pa * PP + e / PP, b = pb * PP + e % PP;
    if (pa > pb || a > b || b >= m) continue;
    const size_t off = (size_t)e * n_patches + patch_index(pa, pb, np);
    // four running sums (slice sl into sum sl % 4), so four loads are in
    // flight; still one fixed order
    double s4[4] = {0.0, 0.0, 0.0, 0.0};
    int sl = 0;
    for (; sl + 4 <= n_slices; sl += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) s4[u] += (double)part[(sl + u) * slice_len + off];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (sl + u < n_slices) s4[u] += (double)part[(sl + u) * slice_len + off];
    const double sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    double st = 0.0;
    for (int k = 0; k < q; ++k) {
      const double d = (double)z[(size_t)a * q + k] - (double)z[(size_t)b * q + k];
      st += d * d / exp(2.0 * (double)log_ell[k]);
    }
    const double sf2 = exp((double)log_sf2[0]);
    const double v = (sf2 * sf2) * exp(-0.25 * st) * sum;
    D[(size_t)a * m + b] = v;
    D[(size_t)b * m + a] = v;
  }
}

int launch_psi2_f32(const float* mu, const float* s, const float* w,
                    const float* z, const float* log_sf2,
                    const float* log_ell, int n, int m, int q, int n_slices,
                    int rows_per_slice, float* part, double* D,
                    void* stream) {
  const int nts = (m + TM - 1) / TM;
  const long n_units = (long)nts * (nts + 1) / 2 * n_slices;
  const size_t smem = P2F_SMEM_ELEMS * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The shared-memory attribute once per device: a runtime call per launch
  // costs host time the card waits for.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(psi2_f32_tiles,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  // Units (tile, slice) on gridDim.x, walked grid-stride past its limit.
  const unsigned grid = (unsigned)(n_units < INT_MAX ? n_units : INT_MAX);
  psi2_f32_tiles<<<grid, NT, smem, st>>>(mu, s, w, z, log_ell, n, m, q, nts,
                                         n_slices, rows_per_slice, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long np = (m + PP - 1) / PP;
  const long blocks = (PP * PP * np * np + 255) / 256;
  psi2_f32_reduce<<<(unsigned)(blocks < (1L << 20) ? blocks : 1L << 20), 256,
                    0, st>>>(part, z, log_sf2, log_ell, n_slices, m, q, D);
  return cudaGetLastError();
}

// psi1 over units of (rows [r0, r0 + rows), runs [j0, j0 + rpt)) of the
// output, a run being V = 16 / sizeof(T) consecutive columns of one row.
// Per feature chunk the block stages z of its columns (transposed), its
// rows' mu and 1/(l^2 + s), and their log1p(s / l^2), l^2 = exp(2 log_ell)
// computed here from the log hyper-parameters; each thread then owns up to
// P1I (row, run) items and accumulates their exponents in registers.  The
// rows' log-normalisers are summed once per row, in feature order.
template <typename T>
__global__ void __launch_bounds__(NT)
psi1_tiles(const T* __restrict__ mu, const T* __restrict__ s,
           const T* __restrict__ z, const T* __restrict__ log_sf2,
           const T* __restrict__ log_ell, int n, int m, int q, int rows,
           int rpt, int col_tiles, long n_units, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  constexpr int ZLD = P1C + V;  // zT row stride: 16-byte aligned, staggered banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e2f[64];
  const int qc = min(q, QC);                // features staged at a time
  T* zT = reinterpret_cast<T*>(smem_raw);  // [qc][ZLD]   z of the tile's columns
  T* mus = zT + qc * ZLD;                  // [P1R][RLD]  mu
  T* invs = mus + P1R * RLD;               // [P1R][RLD]  1 / (l^2 + s)
  T* lnk = invs + P1R * RLD;               // [P1R][RLD]  log1p(s / l^2)
  T* lns = lnk + P1R * RLD;                // [P1R]       sum_q log1p(s / l^2)

  const int tid = threadIdx.x;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const T sf2 = exp_t(log_sf2[0]);
  const int runs = (m + V - 1) / V;
  const bool vec = m % V == 0;  // every run starts 16-byte aligned
  for (long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long r0 = unit / col_tiles * rows;
    const int j0 = (int)(unit % col_tiles) * rpt;
    const int nr = (int)min((long)rows, (long)n - r0);
    const int nj = min(rpt, runs - j0);
    const int c0 = j0 * V, nc = min(nj * V, m - c0);
    const int items = nr * nj;
    // The thread's items tid + u NT as (row, run), stepped by (sr, sj)
    // without a division per item.
    const int r1 = tid / nj, j1 = tid % nj, sr = NT / nj, sj = NT % nj;

    T acc[P1I][V];
#pragma unroll
    for (int u = 0; u < P1I; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = T(0);
    for (int k0 = 0; k0 < q; k0 += qc) {
      const int kw = min(qc, q - k0);
      __syncthreads();  // the previous chunk (or unit) is consumed
      for (int e = tid; e < nj * V * kw; e += NT) {  // coalesced rows of z
        const int c = e / kw, k = e % kw;
        zT[k * ZLD + c] = c < nc ? z[(size_t)(c0 + c) * q + k0 + k] : T(0);
      }
      for (int e = tid; e < nr * kw; e += NT) {
        const int r = e / kw, k = e % kw;
        const size_t g = (size_t)(r0 + r) * q + k0 + k;
        const T l2 = exp_t(T(2) * log_ell[k0 + k]), sv = s[g];
        mus[r * RLD + k] = mu[g];
        invs[r * RLD + k] = T(1) / (l2 + sv);
        lnk[r * RLD + k] = log1p_t(sv / l2);
      }
      __syncthreads();
      if (tid < nr) {  // each row's log-normaliser, in feature order
        T a = k0 == 0 ? T(0) : lns[tid];
        for (int k = 0; k < kw; ++k) a += lnk[tid * RLD + k];
        lns[tid] = a;
      }
      int r = r1, j = j1;
#pragma unroll
      for (int u = 0; u < P1I; ++u) {
        if (tid + u * NT >= items) break;
        for (int k = 0; k < kw; ++k) {
          const T mv = mus[r * RLD + k], iv = invs[r * RLD + k];
          T zv[V];
          loadv(zT + k * ZLD + j * V, zv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T d = mv - zv[v];
            acc[u][v] = fma_t(d * iv, d, acc[u][v]);
          }
        }
        j += sj;
        r += sr + (j >= nj);
        j -= j >= nj ? nj : 0;
      }
    }
    __syncthreads();  // the log-normalisers are complete

    // sf2 exp(lognorm - 1/2 sum_q (mu - z)^2 / (l^2 + s)); a warp stores
    // consecutive runs of a row, 16 bytes each where the row stride allows
    int r = r1, j = j1;
#pragma unroll
    for (int u = 0; u < P1I; ++u) {
      if (tid + u * NT >= items) break;
      const int c = c0 + j * V;
      const T ln = T(-0.5) * lns[r];
      T o[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = sf2 * exp_pair(fma_t(T(-0.5), acc[u][v], ln), e2f);
      T* dst = out + (size_t)(r0 + r) * m + c;
      if (vec && c + V <= m) {
        storev(dst, o);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (c + v < m) dst[v] = o[v];
      }
      j += sj;
      r += sr + (j >= nj);
      j -= j >= nj ? nj : 0;
    }
  }
}

// Shared memory of one block, whatever q.
size_t psi2_smem(size_t item) {
  return item * (2 * QC * TM + 2 * RC * TM + PP * PP * NT + 2 * RC * QC + 2 * RC);
}

// psi1: z of min(q, QC) features staged for P1C columns, so a small q
// leaves room for more blocks per SM; at most ~45 KB (f64, q >= QC).
size_t psi1_smem(size_t item, int q) {
  return item * ((q < QC ? q : QC) * (P1C + 16 / item) + 3 * P1R * RLD + P1R);
}

// Scratch of psi2 in elements: the slice partials of D's upper patches,
// then hp (q + 1), the rows' log-normalisers (n) and 1/(2c) (n, q).
size_t psi2_partials(int m, int n_slices) {
  const long np = (m + PP - 1) / PP;
  return (size_t)n_slices * (np * (np + 1) / 2) * (PP * PP);
}

template <typename T>
int launch_psi2(const T* mu, const T* s, const T* w, const T* z,
                const T* log_sf2, const T* log_ell, int n, int m, int q,
                int n_slices, int rows_per_slice, T* scratch, double* D,
                void* stream) {
  const int nts = (m + TM - 1) / TM;
  const long n_units = (long)nts * (nts + 1) / 2 * n_slices;
  T* hp = scratch + psi2_partials(m, n_slices);
  T* lns = hp + q + 1;
  T* ivs = lns + n;
  const size_t smem = psi2_smem(sizeof(T));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  psi2_hyper<T><<<1, 256, 0, st>>>(log_sf2, log_ell, q, hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    psi2_rows<T><<<(n + 255) / 256, 256, 0, st>>>(s, hp, n, q, lns, ivs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // The shared-memory attribute once per device: a runtime call per launch
  // costs host time the card waits for.
  static bool ready[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(psi2_tiles<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  // Units (tile, slice) on gridDim.x, walked grid-stride past its limit.
  const unsigned grid = (unsigned)(n_units < INT_MAX ? n_units : INT_MAX);
  psi2_tiles<T><<<grid, NT, smem, st>>>(mu, w, z, lns, ivs, n, m, q, nts,
                                        n_slices, rows_per_slice, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long blocks = ((long)m * m + 255) / 256;
  psi2_reduce<T><<<(unsigned)(blocks < (1L << 20) ? blocks : 1L << 20), 256, 0,
                   st>>>(scratch, z, hp, n_slices, m, q, D);
  return cudaGetLastError();
}

template <typename T>
int launch_psi1(const T* mu, const T* s, const T* z, const T* log_sf2,
                const T* log_ell, int n, int m, int q, int rows, int rpt,
                int col_tiles, T* out, void* stream) {
  if (n == 0) return cudaSuccess;
  // Under 48 KB of shared memory: no attribute to set.
  const long n_units = ((long)n + rows - 1) / rows * col_tiles;
  const unsigned grid = (unsigned)(n_units < INT_MAX ? n_units : INT_MAX);
  psi1_tiles<T><<<grid, NT, psi1_smem(sizeof(T), q),
                  static_cast<cudaStream_t>(stream)>>>(
      mu, s, z, log_sf2, log_ell, n, m, q, rows, rpt, col_tiles, n_units, out);
  return cudaGetLastError();
}

}  // namespace

// psi2: mu, s (n,q), w (n,), z (m,q), log_sf2 (), log_ell (q,):
// contiguous, one dtype.  Scratch in that dtype: n_slices rows of
// ceil(m/4)(ceil(m/4)+1)/2 patches of 16 partial sums (f64: patch-major,
// then (q + 1)(n + 1) for hp and the rows' terms; f32: entry-major, nothing
// more).  Output D (m,m) f64.
// psi1: mu, s (n,q), z (m,q), log_sf2 (), log_ell (q,): contiguous, one
// dtype; units of `rows` rows by `rpt` runs of 16 / sizeof(T) columns,
// `col_tiles` of them across m (psi1_plan in kernel.py); output (n,m) in
// that dtype.  Each returns cudaGetLastError().
extern "C" int psi2_f32(const float* mu, const float* s, const float* w,
                        const float* z, const float* log_sf2,
                        const float* log_ell, int n, int m, int q,
                        int n_slices, int rows_per_slice, float* scratch,
                        double* D, void* stream) {
  return launch_psi2_f32(mu, s, w, z, log_sf2, log_ell, n, m, q, n_slices,
                         rows_per_slice, scratch, D, stream);
}

extern "C" int psi2_f64(const double* mu, const double* s, const double* w,
                        const double* z, const double* log_sf2,
                        const double* log_ell, int n, int m, int q,
                        int n_slices, int rows_per_slice, double* scratch,
                        double* D, void* stream) {
  return launch_psi2<double>(mu, s, w, z, log_sf2, log_ell, n, m, q,
                             n_slices, rows_per_slice, scratch, D, stream);
}

extern "C" int psi1_f32(const float* mu, const float* s, const float* z,
                        const float* log_sf2, const float* log_ell, int n,
                        int m, int q, int rows, int rpt, int col_tiles,
                        float* out, void* stream) {
  return launch_psi1<float>(mu, s, z, log_sf2, log_ell, n, m, q, rows, rpt,
                            col_tiles, out, stream);
}

extern "C" int psi1_f64(const double* mu, const double* s, const double* z,
                        const double* log_sf2, const double* log_ell, int n,
                        int m, int q, int rows, int rpt, int col_tiles,
                        double* out, void* stream) {
  return launch_psi1<double>(mu, s, z, log_sf2, log_ell, n, m, q, rows, rpt,
                             col_tiles, out, stream);
}
