// Backward of the fused regression map step for Hopper (sm_90a): the
// vector-Jacobian product of
//
//     b = sf2 * sum_i w_i,   C = knm^T (w . Y),   D = (knm . w)^T knm
//
// with knm[i, j] = sf2 * exp(-1/2 sum_q (x_iq - z_jq)^2 / ell_q^2), for the
// cotangents (gb, gC, gD).  With S = gD + gD^T and P = Y gC^T (n, m), the
// cotangent of knm is G = w . (knm S + P), and with E = G . knm and
// r = x_i - z_j (per feature):
//
//     d log_sf2   = sum E  (+ gb b, added by the wrapper)
//     d z_jq      = sum_i E_ij r / ell_q^2
//     d log_ell_q = sum_ij E_ij r^2 / ell_q^2
//     d x_iq      = -sum_j E_ij r / ell_q^2                   (when asked)
//     d y_i       = w_i knm_i gC                              (when asked)
//     d w_i       = sf2 gb + knm_i . (1/2 (knm S)_i + P_i)    (when asked)
//
// (kernels/reg_stats/ref.py::reg_stats_vjp_ref states the same function).
//
// Replaces the backward of the TPU kernel's custom_vjp,
// src/repro/kernels/reg_stats/ops.py:62 (jax.vjp of reg_stats_dense, the
// recompute through XLA); the port recomputed the plain version under
// autograd in row chunks.
//
// What bounds it on the H100: operations.  knm S is n*m*m multiply-adds
// (2.6e11 at n = 1e6, m = 512), twice the forward's upper-half D product,
// against ~52 MB of input; knm is rebuilt, as in the forward, m/128 times
// per entry.  The design (both instantiations):
//   * knm S as a GEMM whose A operand is built on the fly: a block owns a
//     slice of 128-row tiles and, for each row tile, walks the 128-column
//     tiles of the output; for each it runs a k-loop over the inducing
//     points 32 at a time, building the (32 x 128 rows) slab of knm from x
//     and z in shared memory while S's (32 x 128) rows stream in by
//     cp.async.  The slab of step c+1 is built while step c's product
//     runs (double-buffered slabs, one barrier a step), as in the forward.
//     Neither knm nor knm S is ever stored in device memory.
//   * The epilogue of each (row tile, column tile) writes knm S to shared
//     memory (the slab buffers), then turns it into E in place, entry by
//     entry (two threads a row, each half the columns, four columns' chains
//     side by side: knm recomputed, P by d FMAs over gC staged in shared
//     memory, the weight), and reduces E by columns: d z (two threads a
//     column, each half the rows, added in a fixed order), d log_ell and
//     sum E (each thread's sums, then a warp butterfly and the warps in
//     order).  Row outputs, when asked, are summed by rows in the entry
//     pass (d w, d y) or after it (d x, one thread a row).  At
//     sgpr-synth-1m the epilogue takes about a quarter of the time, the
//     k-loop the rest (ablations: PERF.md section 6).
//   * The f64 exp is psi_stats.cu's branch-free exp_pair (table in shared
//     memory), so that a thread's chains interleave; libdevice's exp
//     branches on its range.
//   * The shared outputs (d z, d log_ell, sum E) accumulate, in f64, in the
//     block's own partials in device memory, each entry owned by one
//     thread; a second kernel sums the slices' partials in a fixed order.
//     The row outputs are owned by the block that owns the rows, summed
//     over the column tiles in order.  No atomics: bitwise repeatable.
//   * The exponent and r are in the direct form (the forward's reasons).
//   * Ragged edges: z, S and gC come zero-padded to a multiple of 128
//     rows, so padded inducing points contribute exactly zero (their S
//     rows and columns and gC rows are 0); rows past n carry w = 0, x = 0
//     and are never written.  The k-loop stops at the last 32-point step
//     holding a point below m.
//   * Shared memory is fixed, whatever q and d: features are staged
//     QC = 16 at a time; past that (CHUNKED) x and z are read from device
//     memory (L1), the slow but general path no config of the repo takes.
//
// f64: the product on the FP64 tensor cores (mma.sync m16n8k4, the
// forward's fragments: 8 warps, each 64 rows x 32 columns as 4 x 4
// fragments).  f32: FMA micro-tiles on the CUDA cores (8 x 8 per thread,
// float4 slab loads, the forward's layout), IEEE f32, no TF32; its exp is
// one ex2.approx.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/reg_stats/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;   // rows per row tile
constexpr int BC = 128;   // columns per column tile
constexpr int KS = 32;    // inducing points per k-step
constexpr int NT = 256;   // threads per block
constexpr int QC = 16;    // features staged at a time
constexpr int QP = QC + 1;  // staged row stride of x and z (odd: no conflicts)
constexpr int ELD = BC + 1; // E tile row stride
constexpr int GROUPS = 4;   // build/product interleave groups of a k-step
constexpr int GC = 8;       // gC columns staged for the epilogue
constexpr int JU = 4;       // columns of the entry pass taken side by side

template <typename T> struct Cfg;
template <> struct Cfg<double> { static constexpr int LD = BR + 4; };  // DMMA loads
template <> struct Cfg<float> { static constexpr int LD = BR; };       // float4 loads

template <typename T>
constexpr size_t smem_elems() {
  // max(slabs A and B double-buffered, the E tile), x and z tiles, z of
  // three k-steps, w, 1/ell^2, 8 columns of gC, the reduction scratch
  return (4 * KS * Cfg<T>::LD > BR * ELD ? 4 * KS * Cfg<T>::LD : BR * ELD)
         + 2 * BR * QP + 3 * KS * QC + BR + QC + BC * GC + BC * QP + 8 * (QC + 1);
}

__device__ __forceinline__ void cp_async(double* dst, const double* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// 16 bytes global -> shared (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// sf2 exp(-1/2 e), e = sum_q (x_q - z_q)^2 / ell_q^2.  f64: psi_stats.cu's
// branch-free exp_pair (so a thread's chains interleave; its error one
// rounding beyond a 4e-18 polynomial), the table tab staged in shared
// memory.  f32: one ex2.approx.
__device__ __forceinline__ double kexp(double sf2, double e, const double* tab) {
  constexpr double kShift = 0x1.8p+52;
  constexpr double kInvLn2_32 = 0x1.71547652b82fep+5;
  constexpr double kLn2_32Hi = 0x1.62e42fef00000p-6;
  constexpr double kLn2_32Lo = 0x1.473de6af278edp-39;
  double x = -0.5 * e;
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
  const double v = hi + fma(hi, p * r, lo);
  const int m = n >> 5, m1 = m >> 1;
  return sf2 * (v * __hiloint2double((m1 + 1023) << 20, 0)
                  * __hiloint2double((m - m1 + 1023) << 20, 0));
}
__device__ __forceinline__ float kexp(float sf2, float e, const double*) {
  float r;
  const float v = e * -0.72134752044448170368f;  // -log2(e) / 2
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return sf2 * r;
}

__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
// Butterfly sum over the warp: every lane ends with the same value, the
// additions in a fixed order.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += shfl_xor(v, o);
  return v;
}

// c (16 x 8) += a (16 x 4) b (4 x 8) in f64 (the forward's fragment).
__device__ __forceinline__ void dmma(double* c, const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// The thread's accumulator entry e (0..63) as (row, column) of the tile.
// f64: fragment (mt, nt) of the warp's 64 x 32 part, entry e & 3 of it.
// f32: the 8 x 8 micro-tile, rows rg*4 + {0..3} and 64 + ..., columns
// likewise.
__device__ __forceinline__ void entry_rc(double*, int e, int warp, int lane,
                                         int& i, int& j) {
  const int mt = e >> 4, nt = (e >> 2) & 3, h = e & 3;
  i = (warp / 4) * 64 + mt * 16 + lane / 4 + 8 * (h >> 1);
  j = (warp % 4) * 32 + nt * 8 + 2 * (lane % 4) + (h & 1);
}
__device__ __forceinline__ void entry_rc(float*, int e, int warp, int lane,
                                         int& i, int& j) {
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
  const int ii = e >> 3, jj = e & 7;
  i = (ii >> 2) * 64 + rg * 4 + (ii & 3);
  j = (jj >> 2) * 64 + cg * 4 + (jj & 3);
}

// Rows [g*KS/GROUPS, (g+1)*KS/GROUPS) of one k-step's product acc += A B
// with A = slab (k x rows, row stride LD) and B = S rows (k x columns).
__device__ __forceinline__ void product(double* acc, const double* as,
                                        const double* bs, int g, int warp,
                                        int lane) {
  constexpr int LD = Cfg<double>::LD;
  const int gid = lane / 4, tig = lane % 4;
  const int i0 = (warp / 4) * 64, j0 = (warp % 4) * 32;
#pragma unroll
  for (int kk = g * KS / GROUPS / 4; kk < (g + 1) * KS / GROUPS / 4; ++kk) {
    const int k = 4 * kk + tig;
    double af[4][2], bf[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      af[mt][0] = as[k * LD + i0 + mt * 16 + gid];
      af[mt][1] = as[k * LD + i0 + mt * 16 + gid + 8];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bf[nt] = bs[k * LD + j0 + nt * 8 + gid];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dmma(acc + 4 * (mt * 4 + nt), af[mt], bf[nt]);
  }
}
__device__ __forceinline__ void product(float* acc, const float* as,
                                        const float* bs, int g, int warp,
                                        int lane) {
  constexpr int LD = Cfg<float>::LD;
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
#pragma unroll
  for (int k = g * KS / GROUPS; k < (g + 1) * KS / GROUPS; ++k) {
    float av[8], bv[8];
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * LD + rg * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * LD + 64 + rg * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * LD + cg * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * LD + 64 + cg * 4);
    av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
    av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[ii * 8 + jj] = fmaf(av[ii], bv[jj], acc[ii * 8 + jj]);
  }
}

// One block: the row tiles [slice * tiles_per_slice, ...) of x, every
// column tile of each.  hp = [sf2, sf2 * gb, 1/ell^2 (q)].  zp (mp, q), sp
// (mp, mp) = gD + gD^T and gcp (mp, d), zero past m.  Partials (f64) of
// this slice: part_z (mp, q), part_ell (q), part_sf2 (1).  flags: 1 d x,
// 2 d y, 4 d w.
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(NT, sizeof(T) == 8 ? 1 : 2)
reg_stats_bwd_tiles(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, const T* __restrict__ zp,
                    const T* __restrict__ sp, const T* __restrict__ gcp,
                    const T* __restrict__ hp, int n, int m, int q, int d,
                    int mp, int tiles_per_slice, int flags,
                    double* __restrict__ part_z, double* __restrict__ part_ell,
                    double* __restrict__ part_sf2, T* __restrict__ dx,
                    T* __restrict__ dy, T* __restrict__ dw) {
  constexpr int LD = Cfg<T>::LD;
  constexpr int TILE_ELEMS = 4 * KS * LD > BR * ELD ? 4 * KS * LD : BR * ELD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // slabs [2][KS][LD], S rows [2][KS][LD]; or E [BR][ELD]
  T* xs = tiles + TILE_ELEMS;                 // [BR][QP]   x of the row tile
  T* zs = xs + BR * QP;                       // [BC][QP]   z of the column tile
  T* zk = zs + BC * QP;                       // [3][KS][QC] z of a k-step
  T* ws = zk + 3 * KS * QC;                   // [BR]
  T* inv = ws + BR;                           // [QC]
  T* gcs = inv + QC;                          // [BC][GC]   gC of the column tile
  T* red = gcs + BC * GC;                     // [BC][QP]   the second half's sums
  T* wred = red + BC * QP;                    // [QC + 1][8] warps' sums
  __shared__ double e2f[64];                  // kExp2Frac, for the f64 exp

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int slice = blockIdx.x;
  const int nts = mp / BC;
  const int row_tiles = (n + BR - 1) / BR;
  const int rt_lo = slice * tiles_per_slice;
  const int rt_hi = min(row_tiles, rt_lo + tiles_per_slice);
  const int nk = (m + KS - 1) / KS;
  const T sf2 = hp[0], sf2gb = hp[1];
  const T* ivg = hp + 2;

  double* pz = part_z + (size_t)slice * mp * q;
  for (int e = tid; e < mp * q; e += NT) pz[e] = 0.0;
  if (tid < q) part_ell[(size_t)slice * q + tid] = 0.0;
  if (tid == 0) part_sf2[slice] = 0.0;
  if (!CHUNKED)
    for (int e = tid; e < q; e += NT) inv[e] = ivg[e];

  // x of row tile row r (local), feature f
  auto xval = [&](int row0, int r, int f) -> T {
    if (CHUNKED) return row0 + r < n ? x[(size_t)(row0 + r) * q + f] : T(0);
    return xs[r * QP + f];
  };
  auto ivf = [&](int f) -> T { return CHUNKED ? ivg[f] : inv[f]; };
  // Rows [g*KS/GROUPS, ...) of a k-step's slab: knm[r][kb + k] at
  // as[k * LD + r].  Thread: row r = tid % BR, half of the group's k.
  auto build = [&](T* as, const T* zb, int row0, int kb, int g) {
    const int r = tid % BR;
    constexpr int U = KS / GROUPS / 2;
    const int k0 = g * (KS / GROUPS) + (tid / BR) * U;
    T e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) e[u] = T(0);
    if (CHUNKED) {
      for (int f = 0; f < q; ++f) {
        const T xv = xval(row0, r, f), iv = ivg[f];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const T dv = xv - zp[(size_t)(kb + k0 + u) * q + f];
          e[u] = fma(dv * dv, iv, e[u]);
        }
      }
    } else {
#pragma unroll
      for (int f = 0; f < QC; ++f)
        if (f < q) {
          const T xv = xs[r * QP + f], iv = inv[f];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const T dv = xv - zb[(k0 + u) * QC + f];
            e[u] = fma(dv * dv, iv, e[u]);
          }
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) as[(k0 + u) * LD + r] = kexp(sf2, e[u], e2f);
  };
  // S rows [kb, kb + KS) of the column tile b0 into bs; z of the step's
  // points into zb (not CHUNKED)
  auto issue_s = [&](T* bs, int kb, int b0) {
    constexpr int V = 16 / sizeof(T);
    for (int e = tid; e < KS * (BC / V); e += NT) {
      const int k = e / (BC / V), c = (e % (BC / V)) * V;
      cp_async16(bs + k * LD + c, sp + (size_t)(kb + k) * mp + b0 + c);
    }
  };
  auto issue_z = [&](T* zb, int kb) {
    if (!CHUNKED) {
      for (int e = tid; e < KS * q; e += NT) {
        const int k = e / q, f = e % q;
        cp_async(zb + k * QC + f, zp + (size_t)(kb + k) * q + f, true);
      }
    }
  };

  T acc[64];
  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int row0 = rt * BR;
    __syncthreads();  // the previous tile's reductions are done with xs, ws
    for (int e = tid; e < BR; e += NT) ws[e] = row0 + e < n ? w[row0 + e] : T(0);
    if (!CHUNKED)
      for (int e = tid; e < BR * q; e += NT) {
        const int r = e / q, f = e % q;
        xs[r * QP + f] = row0 + r < n ? x[(size_t)(row0 + r) * q + f] : T(0);
      }

    for (int b = 0; b < nts; ++b) {
      const int b0 = b * BC;
      T* slab = tiles;                  // [2][KS][LD]
      T* et = tiles;                    // [BR][ELD] after the k-loop
      T* srow = tiles + 2 * KS * LD;    // [2][KS][LD]
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = T(0);
      __syncthreads();  // the E tile and staged z of the last column tile are free
      issue_s(srow, 0, b0);
      issue_z(zk, 0);
      if (nk > 1) issue_z(zk + KS * QC, KS);
      cp_commit();
      cp_wait_all();
      __syncthreads();  // xs, ws, step 0's S rows and z of steps 0, 1
      for (int g = 0; g < GROUPS; ++g) build(slab, zk, row0, 0, g);

      for (int c = 0; c < nk; ++c) {
        cp_wait_all();
        __syncthreads();  // slab c built, S rows of step c in; step c-1 done
        if (c + 1 < nk) issue_s(srow + ((c + 1) & 1) * KS * LD, (c + 1) * KS, b0);
        if (c + 2 < nk) issue_z(zk + ((c + 2) % 3) * KS * QC, (c + 2) * KS);
        cp_commit();
        const T* as = slab + (c & 1) * KS * LD;
        const T* bs = srow + (c & 1) * KS * LD;
        T* nxt = slab + ((c + 1) & 1) * KS * LD;
        const T* znx = zk + ((c + 1) % 3) * KS * QC;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          product(acc, as, bs, g, warp, lane);
          if (c + 1 < nk) build(nxt, znx, row0, (c + 1) * KS, g);
        }
      }
      cp_wait_all();
      __syncthreads();  // every product done: the buffers take the E tile
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        int i, j;
        entry_rc(static_cast<T*>(nullptr), e, warp, lane, i, j);
        et[i * ELD + j] = acc[e];  // (knm S)[i][j]
      }
      if constexpr (!CHUNKED)
        for (int e = tid; e < BC * q; e += NT) {
          const int j = e / q, f = e % q;
          zs[j * QP + f] = zp[(size_t)(b0 + j) * q + f];
        }
      for (int e = tid; e < BC * GC; e += NT) {
        const int j = e / GC, c = e % GC;
        gcs[e] = c < d ? gcp[(size_t)(b0 + j) * d + c] : T(0);
      }
      __syncthreads();

      // Entry by entry: E = w knm (knm S + P) in place; the row sums of
      // knm (1/2 knm S + P) (d w) and of knm gC (d y, GC columns a pass)
      // when asked.  Thread: row i, the columns of half h.
      {
        const int i = tid % BR, h = tid / BR, row = row0 + i;
        const bool live = row < n;
        const T wi = ws[i];
        T xi[QC], yi[GC];
    #pragma unroll
        for (int f = 0; f < QC; ++f) xi[f] = f < q && !CHUNKED ? xs[i * QP + f] : T(0);
    #pragma unroll
        for (int c = 0; c < GC; ++c) yi[c] = live && c < d ? y[(size_t)row * d + c] : T(0);
        auto knm = [&](int j) -> T {
          T e = T(0);
          if constexpr (CHUNKED) {
            for (int f = 0; f < q; ++f) {
              const T dv = xval(row0, i, f) - zp[(size_t)(b0 + j) * q + f];
              e = fma(dv * dv, ivg[f], e);
            }
          } else {
    #pragma unroll
            for (int f = 0; f < QC; ++f)
              if (f < q) {
                const T dv = xi[f] - zs[j * QP + f];
                e = fma(dv * dv, inv[f], e);
              }
          }
          return kexp(sf2, e, e2f);
        };
        T hs = T(0), ys[GC];
    #pragma unroll
        for (int c = 0; c < GC; ++c) ys[c] = T(0);
        // JU columns at a time, their chains side by side
        for (int jj = 0; jj < BC / 2; jj += JU) {
          const int j = h * (BC / 2) + jj;
          T ks[JU], ex[JU], kv[JU], p[JU];
    #pragma unroll
          for (int u = 0; u < JU; ++u) {
            ks[u] = et[i * ELD + j + u];
            ex[u] = p[u] = T(0);
          }
          if constexpr (CHUNKED) {
            for (int f = 0; f < q; ++f) {
              const T xv = xval(row0, i, f);
    #pragma unroll
              for (int u = 0; u < JU; ++u) {
                const T dv = xv - zp[(size_t)(b0 + j + u) * q + f];
                ex[u] = fma(dv * dv, ivg[f], ex[u]);
              }
            }
          } else {
    #pragma unroll
            for (int f = 0; f < QC; ++f)
              if (f < q) {
    #pragma unroll
                for (int u = 0; u < JU; ++u) {
                  const T dv = xi[f] - zs[(j + u) * QP + f];
                  ex[u] = fma(dv * dv, inv[f], ex[u]);
                }
              }
          }
    #pragma unroll
          for (int u = 0; u < JU; ++u) kv[u] = kexp(sf2, ex[u], e2f);
    #pragma unroll
          for (int c = 0; c < GC; ++c)
            if (c < d)
    #pragma unroll
              for (int u = 0; u < JU; ++u) p[u] = fma(yi[c], gcs[(j + u) * GC + c], p[u]);
          if (live)
            for (int c = GC; c < d; ++c)
    #pragma unroll
              for (int u = 0; u < JU; ++u)
                p[u] = fma(y[(size_t)row * d + c], gcp[(size_t)(b0 + j + u) * d + c], p[u]);
    #pragma unroll
          for (int u = 0; u < JU; ++u) {
            et[i * ELD + j + u] = wi * kv[u] * (ks[u] + p[u]);
            if (flags & 4) hs = fma(kv[u], fma(T(0.5), ks[u], p[u]), hs);
            if (flags & 2)
    #pragma unroll
              for (int c = 0; c < GC; ++c)
                if (c < d) ys[c] = fma(kv[u], gcs[(j + u) * GC + c], ys[c]);
          }
        }
        // the halves' sums, added in order; d y past 8 columns in passes
        for (int c0 = 0; (flags & 6) && c0 < ((flags & 2) ? d : 1); c0 += GC) {
          if (c0 > 0) {
    #pragma unroll
            for (int c = 0; c < GC; ++c) ys[c] = T(0);
            for (int jj = 0; jj < BC / 2; ++jj) {
              const int j = h * (BC / 2) + jj;
              const T kv = knm(j);
    #pragma unroll
              for (int c = 0; c < GC; ++c)
                if (c0 + c < d) ys[c] = fma(kv, gcp[(size_t)(b0 + j) * d + c0 + c], ys[c]);
            }
          }
          if (h == 1) {
            red[i * QP] = hs;
    #pragma unroll
            for (int c = 0; c < GC; ++c) red[i * QP + 1 + c] = ys[c];
          }
          __syncthreads();
          if (h == 0 && live) {
            if ((flags & 4) && c0 == 0)
              dw[row] = (b == 0 ? sf2gb : dw[row]) + (hs + red[i * QP]);
            if (flags & 2)
    #pragma unroll
              for (int c = 0; c < GC; ++c)
                if (c0 + c < d) {
                  const size_t o = (size_t)row * d + c0 + c;
                  dy[o] = (b == 0 ? T(0) : dy[o]) + wi * (ys[c] + red[i * QP + 1 + c]);
                }
          }
          __syncthreads();
        }
      }

      __syncthreads();  // the E tile is complete
      // By columns: d z, d log_ell, sum E.  Thread: column j, rows of half h.
      {
        const int j = tid % BC, h = tid / BC;
        const int r_lo = h * (BR / 2);
        T se = T(0);
        for (int r = r_lo; r < r_lo + BR / 2; ++r) se += et[r * ELD + j];
        for (int f0 = 0; f0 < q; f0 += QC) {
          T sz[QC], sl[QC], zj[QC];
    #pragma unroll
          for (int f = 0; f < QC; ++f) {
            sz[f] = sl[f] = T(0);
            if constexpr (CHUNKED)
              zj[f] = f0 + f < q ? zp[(size_t)(b0 + j) * q + f0 + f] : T(0);
            else
              zj[f] = f < q ? zs[j * QP + f] : T(0);
          }
          for (int r = r_lo; r < r_lo + BR / 2; ++r) {
            const T ev = et[r * ELD + j];
    #pragma unroll
            for (int f = 0; f < QC; ++f)
              if (f0 + f < q) {
                const T dv = xval(row0, r, f0 + f) - zj[f];
                const T t = ev * dv;
                sz[f] += t;
                sl[f] = fma(t, dv, sl[f]);
              }
          }
          if (h == 1)
    #pragma unroll
            for (int f = 0; f < QC; ++f) red[j * QP + f] = sz[f];
          // d log_ell: every thread's sums, a warp butterfly, warps in order
    #pragma unroll
          for (int f = 0; f < QC; ++f) {
            const T v = warp_sum(sl[f]);
            if (lane == 0) wred[f * 8 + warp] = v;
          }
          if (f0 == 0) {
            const T v = warp_sum(se);
            if (lane == 0) wred[QC * 8 + warp] = v;
          }
          __syncthreads();
          if (h == 0 && b0 + j < m)
    #pragma unroll
            for (int f = 0; f < QC; ++f)
              if (f0 + f < q)
                pz[(size_t)(b0 + j) * q + f0 + f] +=
                    (double)((sz[f] + red[j * QP + f]) * ivf(f0 + f));
          if (tid < QC + 1 && (tid == QC ? f0 == 0 : f0 + tid < q)) {
            T s = T(0);
            for (int k = 0; k < 8; ++k) s += wred[tid * 8 + k];
            if (tid == QC) part_sf2[slice] += (double)s;
            else part_ell[(size_t)slice * q + f0 + tid] += (double)(s * ivf(f0 + tid));
          }
          __syncthreads();
        }
      }

      // d x: by rows, one thread a row.
      if ((flags & 1) && tid < BR && row0 + tid < n) {
        const int i = tid;
        for (int f = 0; f < q; ++f) {
          const T xv = xval(row0, i, f);
          T s = T(0);
          for (int j = 0; j < BC; ++j) {
            T zv;
            if constexpr (CHUNKED) zv = zp[(size_t)(b0 + j) * q + f];
            else zv = zs[j * QP + f];
            s = fma(et[i * ELD + j], xv - zv, s);
          }
          const size_t o = (size_t)(row0 + i) * q + f;
          dx[o] = (b == 0 ? T(0) : dx[o]) - s * ivf(f);
        }
      }
    }
  }
}

// Fixed-order f64 sum of the slices' partials.
__global__ void reg_stats_bwd_reduce(const double* __restrict__ part_z,
                                     const double* __restrict__ part_ell,
                                     const double* __restrict__ part_sf2,
                                     int n_slices, int m, int q, int mp,
                                     double* __restrict__ dz,
                                     double* __restrict__ dell,
                                     double* __restrict__ dsf2) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (long)m * q) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_z[(size_t)sl * mp * q + e];
    dz[e] = s;
  }
  if (e < q) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_ell[(size_t)sl * q + e];
    dell[e] = s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_sf2[sl];
    *dsf2 = s;
  }
}

template <typename T>
int launch(const T* x, const T* y, const T* w, const T* zp, const T* sp,
           const T* gcp, const T* hp, int n, int m, int q, int d, int mp,
           int n_slices, int tiles_per_slice, int flags, double* part_z,
           double* part_ell, double* part_sf2, double* dz, double* dell,
           double* dsf2, T* dx, T* dy, T* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool chunked = q > QC;
  auto kernel = chunked ? reg_stats_bwd_tiles<T, true> : reg_stats_bwd_tiles<T, false>;
  const int smem = (int)(smem_elems<T>() * sizeof(T));
  // The attribute once per device and variant: a runtime call per launch
  // costs host time the card waits for.
  static bool ready[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][chunked]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][chunked] = true;
  }
  kernel<<<(unsigned)n_slices, NT, smem, s>>>(
      x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, tiles_per_slice, flags,
      part_z, part_ell, part_sf2, dx, dy, dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * q > 1 ? (long)m * q : 1;
  reg_stats_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_z, part_ell, part_sf2, n_slices, m, q, mp, dz, dell, dsf2);
  return cudaGetLastError();
}

static_assert(smem_elems<double>() * sizeof(double) <= 232448 - 512,
              "f64 block over sm_90's 227 KB beside the exp table");
static_assert(smem_elems<float>() * sizeof(float) <= 232448 / 2 - 512,
              "two f32 blocks an SM, each beside the exp table");

}  // namespace

// x (n, q), y (n, d), w (n,): the forward's inputs.  zp (mp, q), sp (mp,
// mp) = gD + gD^T, gcp (mp, d): zero past m, mp = 128 ceil(m / 128).  hp =
// [sf2, sf2 gb, 1/ell^2 (q)].  One block per slice of tiles_per_slice
// 128-row tiles (n_slices of them, at least one).  Scratch (f64): part_z
// (n_slices, mp, q), part_ell (n_slices, q), part_sf2 (n_slices).  Outputs
// (f64): dz (m, q), dell (q), dsf2 (), the latter without gb b; when flags
// asks (1, 2, 4), dx (n, q), dy (n, d), dw (n) in the input dtype.  Any q
// and d: shared memory is fixed.  Returns cudaGetLastError().
extern "C" int reg_stats_bwd_f64(const double* x, const double* y, const double* w,
                                 const double* zp, const double* sp,
                                 const double* gcp, const double* hp, int n,
                                 int m, int q, int d, int mp, int n_slices,
                                 int tiles_per_slice, int flags, double* part_z,
                                 double* part_ell, double* part_sf2, double* dz,
                                 double* dell, double* dsf2, double* dx,
                                 double* dy, double* dw, void* stream) {
  return launch<double>(x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, n_slices,
                        tiles_per_slice, flags, part_z, part_ell, part_sf2, dz,
                        dell, dsf2, dx, dy, dw, stream);
}

extern "C" int reg_stats_bwd_f32(const float* x, const float* y, const float* w,
                                 const float* zp, const float* sp,
                                 const float* gcp, const float* hp, int n,
                                 int m, int q, int d, int mp, int n_slices,
                                 int tiles_per_slice, int flags, double* part_z,
                                 double* part_ell, double* part_sf2, double* dz,
                                 double* dell, double* dsf2, float* dx,
                                 float* dy, float* dw, void* stream) {
  return launch<float>(x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, n_slices,
                       tiles_per_slice, flags, part_z, part_ell, part_sf2, dz,
                       dell, dsf2, dx, dy, dw, stream);
}
