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
// (2.6e11 at n = 1e6, m = 512) against ~52 MB of input, on the FP64 tensor
// cores; building knm (n*m exps and 3q + 2 flops an entry) shares the FP64
// pipe with it.  So each knm entry is built once a call (the first design
// built it m/128 + 1 times: once in each column tile's k-loop and once in
// its epilogue), and the design (both instantiations):
//   * A thread-block cluster of CS = min(m/128, 8) blocks shares a 64-row
//     tile of x.  Block r of the cluster owns the output's column tiles r,
//     r + CS, ... (128 inducing points each) and builds knm of the row
//     tile against its own tile's points into its shared memory (128 x 64,
//     the "own" tile), once, as a phase of its own (all 8 warps, 8 exps'
//     chains a thread side by side).  After a cluster barrier, each block
//     runs the k-loop of its (64 x 128) block of knm S over every inducing
//     point: step by step (32 points) the slab of knm comes from the own
//     tile of the block that built it, its own read in place, another's
//     copied by ld.shared::cluster (distributed shared memory) into
//     registers while the step before multiplies, half a slab at a time,
//     then into a double-buffered slab.  Each block starts at its own
//     tile's steps and wraps around, so at each step the blocks read
//     different blocks' tiles (all reading one block's tile at once made
//     its SM the bottleneck).  S's rows stream in by cp.async,
//     double-buffered (a third stage measured slower: their L2 traffic, 32
//     GB at sgpr-synth-1m, twice the 128-row design's, is the k-loop's
//     limit, not their latency).  Neither knm nor knm S is ever stored in
//     device memory.
//   * Past CS * 128 = 1,024 points the output's column tiles and the k
//     points go in groups of CS tiles: for each group of output tiles the
//     k-loop walks the k groups, the block's own group last, building each
//     group's own tiles anew (so m <= 1,024, every config of the repo,
//     builds knm once; m = 2,048 twice).  That instantiation (GROUPED)
//     keeps its sums live across the builds; the other does not, so its
//     registers fit without spilling.
//   * The epilogue of each (row tile, column tile) reads knm from the own
//     tile, which still holds its column tile's points: it is not
//     recomputed.  It writes knm S to shared memory (the slab buffers),
//     turns it into E in place, entry by entry (four threads a row, each a
//     quarter of the columns: P by d FMAs over gC staged in shared memory,
//     the weight), and reduces E by columns: d z (two threads a column,
//     each half the rows, added in a fixed order), d log_ell and sum E
//     (each thread's sums, then a warp butterfly and the warps in order).
//     Row outputs, when asked, are summed by rows in the entry pass (d w,
//     d y) or after it (d x, one thread a row), into the block's rank's
//     row partials, which a last kernel adds over the ranks in order.
//   * The product: the 8 warps are two k-groups of 4, each taking half of
//     a step's 32 points over the whole (64 x 128) block, their sums added
//     in the epilogue.  That keeps the forward's register tiles (f64: a
//     warp 64 x 32 as 4 x 4 DMMA fragments; f32: a thread 8 x 8) and so
//     their shared-memory traffic per multiply-add.
//   * The f64 exp is psi_stats.cu's branch-free exp_pair (table in shared
//     memory), so that a thread's chains interleave.  In f64 at q <= 8 (the
//     KQ = 8 instantiation: every config of the repo) the build's feature
//     loop is unrolled without a guard on q (x, z and 1/ell^2 zero past q),
//     so its loads issue ahead of the chains: 24.2-24.4 ms against 25.0-25.2
//     at sgpr-synth-1m (H100 80GB HBM3, 700 W, tools/bwd_ablation.py, the
//     parent in the same call), results bitwise the same.  f32 and q past 8
//     keep the guarded loop (unguarded, f32 was 4% slower and q 9-16 spilled).
//   * What bounds it now (the same tool): the DMMA loop with its frame,
//     11.7 ms alone; the epilogue 5.7; S's rows 2.2; the build 1.9; the
//     copies 1.0; none overlaps the product.  Tried and dropped: the column
//     pass (d z, d log_ell, sum E) as one DMMA product a tile, E^T [1, x~,
//     x~^2] with x and z centred on the mean of z (27.45 ms against 25.17:
//     the kernel, at 255 registers with no spill, spilled 220 bytes, and
//     the epilogue did not shrink); the k-loop on sm_90's m16n8k8 f64 shape
//     (24.40 against 24.38).
//   * The shared outputs (d z, d log_ell, sum E) accumulate, in f64, in the
//     blocks' own partials in device memory (d z a cluster's, each column
//     tile's rows owned by one block), each entry owned by one thread; a
//     second kernel sums them in a fixed order.  Clusters walk fixed slices
//     of row tiles.  No atomics: bitwise repeatable.
//   * The exponent and r are in the direct form (the forward's reasons).
//   * Ragged edges: z, S and gC come zero-padded to a multiple of 128
//     rows, so padded inducing points contribute exactly zero (their S
//     rows and columns and gC rows are 0); rows past n carry w = 0, x = 0
//     and are never written.  The k-loop stops at the last 32-point step
//     holding a point below m; a block whose column tile is past m in a
//     ragged last group only builds and keeps the cluster's barriers.
//   * Shared memory is fixed, whatever q and d: features are staged
//     QC = 16 at a time; past that (CHUNKED) x and z are read from device
//     memory (L1), the slow but general path no config of the repo takes.
//     f64: the own tile 128 x 68 (69,632 bytes); the buffers, the larger
//     of the slabs and S's rows 2 x 32 x 68 + 2 x 32 x 132 (102,400) and
//     the epilogue's 64 x 129 E tile, z and gC of the column tile, the
//     passes' scratch and the warps' sums (110,144), which also hold z for
//     the build; x, w and 1/ell^2 (9,344): 189,120 bytes and 512 of exp
//     table, of the 232,448 a block may use.  f32 92,512: two blocks an
//     SM.
//
// f64: the product on the FP64 tensor cores (mma.sync m16n8k4; Hopper has
// no f64 wgmma).  f32: FMA micro-tiles on the CUDA cores (float4 slab
// loads), IEEE f32, no TF32; its exp is one ex2.approx.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/reg_stats/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;    // rows per row tile
constexpr int BC = 128;   // columns (inducing points) per column tile
constexpr int KS = 32;    // inducing points per k-step
constexpr int NT = 256;   // threads per block
constexpr int QC = 16;    // features staged at a time
constexpr int QP = QC + 1;  // staged row stride of x and z (odd: no conflicts)
constexpr int ELD = BC + 1; // E tile row stride
constexpr int GC = 8;       // gC columns staged for the epilogue
constexpr int JU = 4;       // columns of the entry pass taken side by side
constexpr int RS = 1 + GC;  // a row's sums of the entry pass (d w, d y)
constexpr int CMAX = 8;     // blocks a cluster, at most (the portable size)
constexpr int BU = 8;       // entries of the build taken side by side
constexpr int CQ = 8;       // features of the column pass taken at a time
constexpr int SS = 2;       // S's rows: double-buffered

template <typename T> struct Cfg;
// LDA: row stride of the own tile and the slabs (k-major, BR rows); LDS:
// of S's rows.  f64 pads both by 4 (4 mod 16: the DMMA fragments' loads
// hit distinct banks); f32 reads float4 rows, unpadded.
template <> struct Cfg<double> { static constexpr int LDA = BR + 4, LDS = BC + 4; };
template <> struct Cfg<float> { static constexpr int LDA = BR, LDS = BC; };

constexpr int RED = BC * QP > 3 * BR * RS ? BC * QP : 3 * BR * RS;  // the passes' scratch

// The buffers: in the k-loop the slabs (two) and S's rows (SS); in the
// epilogue the E tile, z and gC of the column tile, the passes' scratch
// and the warps' sums; z of the own tile for the build.
template <typename T>
__host__ __device__ constexpr int buf_elems() {
  return 2 * KS * Cfg<T>::LDA + SS * KS * Cfg<T>::LDS
                 > BR * ELD + BC * QP + BC * GC + RED + 8 * (QC + 1)
             ? 2 * KS * Cfg<T>::LDA + SS * KS * Cfg<T>::LDS
             : BR * ELD + BC * QP + BC * GC + RED + 8 * (QC + 1);
}

template <typename T>
constexpr size_t smem_elems() {  // the own tile, the buffers, x, w, 1/ell^2
  return BC * Cfg<T>::LDA + buf_elems<T>() + BR * QP + BR + QC;
}

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


// The cluster: this block's rank, the barrier's two halves (arrive with
// release, wait with acquire: shared memory written before an arrive is
// seen by every block of the cluster after the wait), a local shared
// address mapped to the same offset in block `rank`, and 16-byte loads
// from another block's shared memory.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}
__device__ __forceinline__ void ld_cluster(uint32_t a, double (&v)[2]) {
  asm volatile("ld.shared::cluster.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(v[0]), "=d"(v[1]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ld_cluster(uint32_t a, float (&v)[4]) {
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void st_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// The thread's accumulator entry e (0..63) as (row, column) of the 64 x 128
// block; both k-groups hold the same entries.  f64: warp w % 4 owns
// columns 32 (w % 4) + 0..31, fragment (mt, nt) of its 64 x 32 part, entry
// e & 3 of it.  f32: thread t = tid % 128 owns the 8 x 8 micro-tile of rows
// 4 (t / 16) + {0..3} and 32 + ..., columns 4 (t % 16) + {0..3} and 64 + ...
__device__ __forceinline__ void entry_rc(double*, int e, int tid, int& i, int& j) {
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int mt = e >> 4, nt = (e >> 2) & 3, h = e & 3;
  i = mt * 16 + lane / 4 + 8 * (h >> 1);
  j = warp * 32 + nt * 8 + 2 * (lane % 4) + (h & 1);
}
__device__ __forceinline__ void entry_rc(float*, int e, int tid, int& i, int& j) {
  const int t = tid % 128, rg = t >> 4, cg = t & 15;
  const int ii = e >> 3, jj = e & 7;
  i = (ii >> 2) * 32 + rg * 4 + (ii & 3);
  j = (jj >> 2) * 64 + cg * 4 + (jj & 3);
}

// Half `half` of k-group kg's half of one k-step's product acc += A B with
// A = slab (k x BR rows, row stride LDA) and B = S rows (k x BC columns,
// stride LDS): the points kg KS/2 + half KS/4 + 0..KS/4-1 of the step.
__device__ __forceinline__ void product(double* acc, const double* as,
                                        const double* bs, int kg, int half,
                                        int tid) {
  constexpr int LDA = Cfg<double>::LDA, LDS = Cfg<double>::LDS;
  const int lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int j0 = ((tid / 32) % 4) * 32;
#pragma unroll
  for (int t = 0; t < KS / 16; ++t) {
    const int k = 4 * (kg * (KS / 8) + half * (KS / 16) + t) + tig;
    double af[4][2], bf[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      af[mt][0] = as[k * LDA + mt * 16 + gid];
      af[mt][1] = as[k * LDA + mt * 16 + gid + 8];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bf[nt] = bs[k * LDS + j0 + nt * 8 + gid];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dmma(acc + 4 * (mt * 4 + nt), af[mt], bf[nt]);
  }
}
__device__ __forceinline__ void product(float* acc, const float* as,
                                        const float* bs, int kg, int half,
                                        int tid) {
  constexpr int LDA = Cfg<float>::LDA, LDS = Cfg<float>::LDS;
  const int t = tid % 128, rg = t >> 4, cg = t & 15;
#pragma unroll
  for (int u = 0; u < KS / 4; ++u) {
    const int k = kg * (KS / 2) + half * (KS / 4) + u;
    float av[8], bv[8];
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * LDA + rg * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * LDA + 32 + rg * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * LDS + cg * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * LDS + 64 + cg * 4);
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

// One cluster of cs blocks: the row tiles [slice * tiles_per_slice, ...)
// of x; block rank r, the column tiles r, r + cs, ...  hp = [sf2, sf2 * gb,
// 1/ell^2 (q)].  zp (mp, q), sp (mp, mp) = gD + gD^T and gcp (mp, d), zero
// past m.  Partials (f64): part_z (slices, mp, q) by cluster, part_ell
// (blocks, q) and part_sf2 (blocks) by block.  Row partials (flags 1 d x,
// 2 d y, 4 d w) by rank: rp_x (cs, n, q), rp_y (cs, n, d), rp_w (cs, n).
template <typename T, int KQ, bool GROUPED>
__global__ void __launch_bounds__(NT, sizeof(T) == 8 ? 1 : 2)
reg_stats_bwd_tiles(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ w, const T* __restrict__ zp,
                    const T* __restrict__ sp, const T* __restrict__ gcp,
                    const T* __restrict__ hp, int n, int m, int q, int d,
                    int mp, int cs, int tiles_per_slice, int flags,
                    double* __restrict__ part_z, double* __restrict__ part_ell,
                    double* __restrict__ part_sf2, T* __restrict__ rp_x,
                    T* __restrict__ rp_y, T* __restrict__ rp_w) {
  constexpr int LDA = Cfg<T>::LDA, LDS = Cfg<T>::LDS;
  constexpr int V = 16 / sizeof(T);            // elements a 16-byte vector
  constexpr int RV = KS * BR / V / NT;         // a thread's vectors of a slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* own = reinterpret_cast<T*>(smem_raw);     // [BC][LDA]  knm of the own tile's points
  T* buf = own + BC * LDA;                     // the buffers
  T* xs = buf + buf_elems<T>();                // [BR][QP]   x of the row tile
  T* ws = xs + BR * QP;                        // [BR]
  T* inv = ws + BR;                            // [QC]
  T* stg = buf;                                // [2][KS][LDA]  slabs (the k-loop)
  T* srow = buf + 2 * KS * LDA;                // [SS][KS][LDS] S rows (the k-loop)
  T* et = buf;                                 // [BR][ELD]  E (the epilogue)
  T* zs = et + BR * ELD;                       // [BC][QP]   z (the build, the epilogue)
  T* gcs = zs + BC * QP;                       // [BC][GC]   gC (the epilogue)
  T* red = gcs + BC * GC;                      // [RED]      the passes' scratch
  T* wred = red + RED;                         // [QC + 1][8] the warps' sums
  __shared__ double e2f[64];                   // kExp2Frac, for the f64 exp

  constexpr bool CHUNKED = KQ == 0;  // past QC features: x and z from device memory
  // KQ 8 (f64, q <= 8): the build's feature loop unrolled without a guard,
  // x, z and 1/ell^2 zero past q; KQ 16: guarded by q
  const int qs = KQ == 8 ? 8 : q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int blk = blockIdx.x, slice = blk / cs, r = cluster_rank();
  const int kgrp = tid / 128;                  // the thread's k-group
  const int nts = mp / BC, ngroups = GROUPED ? (nts + cs - 1) / cs : 1;
  const int row_tiles = (n + BR - 1) / BR;
  const int rt_lo = slice * tiles_per_slice;
  const int rt_hi = min(row_tiles, rt_lo + tiles_per_slice);
  const T sf2 = hp[0];
  const T* ivg = hp + 2;

  double* pz = part_z + (size_t)slice * mp * q;
  for (int g = 0; g < ngroups; ++g)
    if (g * cs + r < nts)
      for (int e = tid; e < BC * q; e += NT) pz[(size_t)(g * cs + r) * BC * q + e] = 0.0;
  for (int e = tid; e < q; e += NT) part_ell[(size_t)blk * q + e] = 0.0;
  if (tid == 0) part_sf2[blk] = 0.0;
  if (!CHUNKED)
    for (int e = tid; e < qs; e += NT) inv[e] = e < q ? ivg[e] : T(0);

  // x of row tile row i (local), feature f
  auto xval = [&](int row0, int i, int f) -> T {
    if (CHUNKED) return row0 + i < n ? x[(size_t)(row0 + i) * q + f] : T(0);
    return xs[i * QP + f];
  };
  auto ivf = [&](int f) -> T { return CHUNKED ? ivg[f] : inv[f]; };
  // knm of the row tile against the points of column tile tk, into the
  // own tile (own[k * LDA + i]).  Thread: row i = tid % BR, a quarter of
  // the points, BU at a time.
  auto build = [&](int row0, int tk) {
    const int i = tid % BR, k_lo = (tid / BR) * (BC / 4);
#pragma unroll 1
    for (int k0 = k_lo; k0 < k_lo + BC / 4; k0 += BU) {
      T e[BU];
#pragma unroll
      for (int u = 0; u < BU; ++u) e[u] = T(0);
      if (CHUNKED) {
        for (int f = 0; f < q; ++f) {
          const T xv = xval(row0, i, f), iv = ivg[f];
#pragma unroll
          for (int u = 0; u < BU; ++u) {
            const T dv = xv - zp[(size_t)(tk * BC + k0 + u) * q + f];
            e[u] = fma(dv * dv, iv, e[u]);
          }
        }
      } else {
#pragma unroll
        for (int f = 0; f < (KQ == 8 ? 8 : QC); ++f)
          if (KQ == 8 || f < q) {
            const T xv = xs[i * QP + f], iv = inv[f];
#pragma unroll
            for (int u = 0; u < BU; ++u) {
              const T dv = xv - zs[(k0 + u) * QP + f];
              e[u] = fma(dv * dv, iv, e[u]);
            }
          }
      }
#pragma unroll
      for (int u = 0; u < BU; ++u) own[(k0 + u) * LDA + i] = kexp(sf2, e[u], e2f);
    }
  };
  // S rows [p0, p0 + KS) of the column tile b0 into bs
  auto fetch_s = [&](T* bs, int p0, int b0) {
    for (int e = tid; e < KS * (BC / V); e += NT) {
      const int k = e / (BC / V), c = (e % (BC / V)) * V;
      cp_async16(bs + k * LDS + c, sp + (size_t)(p0 + k) * mp + b0 + c);
    }
  };
  // Half `half` of the slab of group point p (KS points, BR rows) from
  // the own tile of the rank that built it, into registers; then into a
  // slab buffer.  In halves, each beside half of the product, so that few
  // registers carry it.
  auto load_slab = [&](T (&rv)[RV / 2][V], int p, int half) {
    const uint32_t base = map_rank(own + (p % BC) * LDA, p / BC);
#pragma unroll
    for (int u = 0; u < RV / 2; ++u) {
      const int e = tid + (half * (RV / 2) + u) * NT;
      const int k = e / (BR / V), c = (e % (BR / V)) * V;
      ld_cluster(base + (uint32_t)((k * LDA + c) * sizeof(T)), rv[u]);
    }
  };
  auto store_slab = [&](T* as, const T (&rv)[RV / 2][V], int half) {
#pragma unroll
    for (int u = 0; u < RV / 2; ++u) {
      const int e = tid + (half * (RV / 2) + u) * NT;
      const int k = e / (BR / V), c = (e % (BR / V)) * V;
      st_vec(as + k * LDA + c, rv[u]);
    }
  };

  T acc[64];
  T rv[RV / 2][V];
  bool arrived = false;  // this thread's cluster arrive awaits its wait
  for (int rt = rt_lo; rt < rt_hi; ++rt) {
    const int row0 = rt * BR;
    for (int g = 0; g < ngroups; ++g) {
      const int b = g * cs + r, b0 = b * BC;  // the output's column tile
      for (int t = 0; t < ngroups; ++t) {
        const int kg = (g + 1 + t) % ngroups;  // the own group last
        const int tk = kg * cs + r;            // the tile this block builds
        __syncthreads();  // the last epilogue / k-loop is done with xs, ws, zs
        if (g == 0 && t == 0) {
          for (int e = tid; e < BR; e += NT) ws[e] = row0 + e < n ? w[row0 + e] : T(0);
          if (!CHUNKED)
            for (int e = tid; e < BR * qs; e += NT) {
              const int i = e / qs, f = e % qs;
              xs[i * QP + f] = row0 + i < n && f < q ? x[(size_t)(row0 + i) * q + f] : T(0);
            }
        }
        if (!CHUNKED && tk < nts)
          for (int e = tid; e < BC * qs; e += NT) {
            const int j = e / qs, f = e % qs;
            zs[j * QP + f] = f < q ? zp[(size_t)(tk * BC + j) * q + f] : T(0);
          }
        __syncthreads();
        if (arrived) cluster_wait();  // every block is done reading the own tiles
        arrived = false;
        if (tk < nts) build(row0, tk);
        cluster_arrive();
        cluster_wait();  // every own tile of the group is built and visible
        if (t == 0)  // not before the build: without GROUPED no sums live across it
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] = T(0);

        if (b < nts) {
          // The steps start at the block's own tile and wrap around, so
          // that at each step the blocks read different blocks' tiles.
          const int gp0 = kg * cs * BC;
          const int nk = (min(m - gp0, cs * BC) + KS - 1) / KS;
          const int c0 = (r * (BC / KS)) % nk;
          auto point = [&](int c) { return (c + c0) % nk * KS; };
          fetch_s(srow, gp0 + point(0), b0);
          cp_commit();
          if (point(0) / BC != r)
            for (int h = 0; h < 2; ++h) {
              load_slab(rv, point(0), h);
              store_slab(stg, rv, h);
            }
          for (int c = 0; c < nk; ++c) {
            cp_wait_all();
            __syncthreads();  // step c's slab and S rows in; step c-1 done
            const int p = point(c), pn = point(c + 1);
            const bool next = c + 1 < nk, remote = next && pn / BC != r;
            if (next) fetch_s(srow + (c + 1) % SS * KS * LDS, gp0 + pn, b0);
            cp_commit();
            const T* as = p / BC == r ? own + (p % BC) * LDA : stg + (c & 1) * KS * LDA;
            T* an = stg + ((c + 1) & 1) * KS * LDA;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (remote) load_slab(rv, pn, h);
              product(acc, as, srow + c % SS * KS * LDS, kgrp, h, tid);
              if (remote) store_slab(an, rv, h);
            }
          }
          cp_wait_all();
        }
        cluster_arrive();  // done reading the others' own tiles
        arrived = true;
      }
      if (b >= nts) continue;

      // The epilogue of (row tile, column tile b): the own tile holds knm
      // of b's points.  The two k-groups' sums, group 1's first.
      __syncthreads();  // every product done: the buffers take the E tile
      if (kgrp == 1)
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          int i, j;
          entry_rc(static_cast<T*>(nullptr), e, tid, i, j);
          et[i * ELD + j] = acc[e];
        }
      for (int e = tid; e < BC * GC; e += NT) {
        const int j = e / GC, c = e % GC;
        gcs[e] = c < d ? gcp[(size_t)(b0 + j) * d + c] : T(0);
      }
      if (!CHUNKED)
        for (int e = tid; e < BC * q; e += NT) {
          const int j = e / q, f = e % q;
          zs[j * QP + f] = zp[(size_t)(b0 + j) * q + f];
        }
      __syncthreads();
      if (kgrp == 0)
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          int i, j;
          entry_rc(static_cast<T*>(nullptr), e, tid, i, j);
          et[i * ELD + j] += acc[e];  // (knm S)[i][j]
        }
      __syncthreads();

      // Entry by entry: E = w knm (knm S + P) in place; the row sums of
      // knm (1/2 knm S + P) (d w) and of knm gC (d y, GC columns a pass)
      // when asked.  Thread: row i, the columns of quarter h.
      {
        const int i = tid % BR, h = tid / BR, row = row0 + i;
        const bool live = row < n;
        const T wi = ws[i];
        T yi[GC];
    #pragma unroll
        for (int c = 0; c < GC; ++c) yi[c] = live && c < d ? y[(size_t)row * d + c] : T(0);
        T hs = T(0), ys[GC];
    #pragma unroll
        for (int c = 0; c < GC; ++c) ys[c] = T(0);
        // JU columns at a time, their chains side by side
#pragma unroll 1
        for (int jj = 0; jj < BC / 4; jj += JU) {
          const int j = h * (BC / 4) + jj;
          T ks[JU], kv[JU], p[JU];
    #pragma unroll
          for (int u = 0; u < JU; ++u) {
            ks[u] = et[i * ELD + j + u];
            kv[u] = own[(j + u) * LDA + i];
            p[u] = T(0);
          }
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
        // the quarters' sums, added in order; d y past 8 columns in passes
        for (int c0 = 0; (flags & 6) && c0 < ((flags & 2) ? d : 1); c0 += GC) {
          if (c0 > 0) {
    #pragma unroll
            for (int c = 0; c < GC; ++c) ys[c] = T(0);
            for (int jj = 0; jj < BC / 4; ++jj) {
              const int j = h * (BC / 4) + jj;
              const T kv = own[j * LDA + i];
    #pragma unroll
              for (int c = 0; c < GC; ++c)
                if (c0 + c < d) ys[c] = fma(kv, gcp[(size_t)(b0 + j) * d + c0 + c], ys[c]);
            }
          }
          if (h > 0) {
            T* rd = red + ((h - 1) * BR + i) * RS;
            rd[0] = hs;
    #pragma unroll
            for (int c = 0; c < GC; ++c) rd[1 + c] = ys[c];
          }
          __syncthreads();
          if (h == 0 && live) {
            if ((flags & 4) && c0 == 0) {
              T s = hs;
              for (int hh = 0; hh < 3; ++hh) s += red[(hh * BR + i) * RS];
              const size_t o = (size_t)r * n + row;
              rp_w[o] = (g == 0 ? T(0) : rp_w[o]) + s;
            }
            if (flags & 2)
    #pragma unroll
              for (int c = 0; c < GC; ++c)
                if (c0 + c < d) {
                  T s = ys[c];
                  for (int hh = 0; hh < 3; ++hh) s += red[(hh * BR + i) * RS + 1 + c];
                  const size_t o = ((size_t)r * n + row) * d + c0 + c;
                  rp_y[o] = (g == 0 ? T(0) : rp_y[o]) + s;
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
        for (int i = r_lo; i < r_lo + BR / 2; ++i) se += et[i * ELD + j];
        for (int f0 = 0; f0 < q; f0 += CQ) {
          T sz[CQ], sl[CQ], zj[CQ];
    #pragma unroll
          for (int f = 0; f < CQ; ++f) {
            sz[f] = sl[f] = T(0);
            if constexpr (CHUNKED)
              zj[f] = f0 + f < q ? zp[(size_t)(b0 + j) * q + f0 + f] : T(0);
            else
              zj[f] = f0 + f < q ? zs[j * QP + f0 + f] : T(0);
          }
    #pragma unroll 2
          for (int i = r_lo; i < r_lo + BR / 2; ++i) {
            const T ev = et[i * ELD + j];
    #pragma unroll
            for (int f = 0; f < CQ; ++f)
              if (f0 + f < q) {
                const T dv = xval(row0, i, f0 + f) - zj[f];
                const T t = ev * dv;
                sz[f] += t;
                sl[f] = fma(t, dv, sl[f]);
              }
          }
          if (h == 1)
    #pragma unroll
            for (int f = 0; f < CQ; ++f) red[j * QP + f] = sz[f];
          // d log_ell: every thread's sums, a warp butterfly, warps in order
    #pragma unroll
          for (int f = 0; f < CQ; ++f)
            if (f0 + f < q) {
              const T v = warp_sum(sl[f]);
              if (lane == 0) wred[f * 8 + warp] = v;
            }
          if (f0 == 0) {
            const T v = warp_sum(se);
            if (lane == 0) wred[CQ * 8 + warp] = v;
          }
          __syncthreads();
          if (h == 0 && b0 + j < m)
    #pragma unroll
            for (int f = 0; f < CQ; ++f)
              if (f0 + f < q)
                pz[(size_t)(b0 + j) * q + f0 + f] +=
                    (double)((sz[f] + red[j * QP + f]) * ivf(f0 + f));
          if (tid < CQ + 1 && (tid == CQ ? f0 == 0 : f0 + tid < q)) {
            T s = T(0);
            for (int k = 0; k < 8; ++k) s += wred[tid * 8 + k];
            if (tid == CQ) part_sf2[blk] += (double)s;
            else part_ell[(size_t)blk * q + f0 + tid] += (double)(s * ivf(f0 + tid));
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
          const size_t o = ((size_t)r * n + row0 + i) * q + f;
          rp_x[o] = (g == 0 ? T(0) : rp_x[o]) - s * ivf(f);
        }
      }
    }
  }
  if (arrived) cluster_wait();  // no block leaves while another reads its tile
}

// Fixed-order f64 sums of the partials: d z over the clusters, d log_ell
// and sum E over the blocks.
__global__ void reg_stats_bwd_reduce(const double* __restrict__ part_z,
                                     const double* __restrict__ part_ell,
                                     const double* __restrict__ part_sf2,
                                     int n_slices, int n_blocks, int m, int q,
                                     int mp, double* __restrict__ dz,
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
    for (int b = 0; b < n_blocks; ++b) s += part_ell[(size_t)b * q + e];
    dell[e] = s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int b = 0; b < n_blocks; ++b) s += part_sf2[b];
    *dsf2 = s;
  }
}

// The row outputs asked for: the ranks' row partials added in rank order;
// d y times w, d w plus sf2 gb.
template <typename T>
__global__ void reg_stats_bwd_rows(const T* __restrict__ rp_x, const T* __restrict__ rp_y,
                                   const T* __restrict__ rp_w, const T* __restrict__ w,
                                   const T* __restrict__ hp, int n, int q, int d,
                                   int cs, int flags, T* __restrict__ dx,
                                   T* __restrict__ dy, T* __restrict__ dw) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nx = (flags & 1) ? (long)n * q : 0, ny = (flags & 2) ? (long)n * d : 0;
  const long nw = (flags & 4) ? n : 0;
  if (e < nx) {
    T s = T(0);
    for (int r = 0; r < cs; ++r) s += rp_x[(size_t)r * nx + e];
    dx[e] = s;
  } else if (e < nx + ny) {
    const long k = e - nx;
    T s = T(0);
    for (int r = 0; r < cs; ++r) s += rp_y[(size_t)r * ny + k];
    dy[k] = w[k / d] * s;
  } else if (e < nx + ny + nw) {
    const long k = e - nx - ny;
    T s = hp[1];
    for (int r = 0; r < cs; ++r) s += rp_w[(size_t)r * nw + k];
    dw[k] = s;
  }
}

// The cluster width for m (padded to mp): one block a column tile, at most
// CMAX.
int cluster_size(int mp) { return mp / BC < CMAX ? mp / BC : CMAX; }

template <typename T>
using TilesFn = decltype(&reg_stats_bwd_tiles<T, QC, false>);

// The instantiation of variant v (0 CHUNKED, 1 KQ 8, f64 only; 2 KQ 16).
template <typename T, bool GROUPED>
TilesFn<T> pick(int v) {
  if constexpr (sizeof(T) == 8)
    if (v == 1) return reg_stats_bwd_tiles<T, 8, GROUPED>;
  return v == 0 ? reg_stats_bwd_tiles<T, 0, GROUPED> : reg_stats_bwd_tiles<T, QC, GROUPED>;
}

// The variant's kernel for q features (f64 at q <= 8: the build's 8
// features unguarded; past 16, CHUNKED: x and z from device memory) and m
// points (past the cluster's 1,024, GROUPED, whose sums stay live across
// the builds), its shared-memory attribute set once per device: a runtime
// call per launch costs host time the card waits for.
template <typename T>
cudaError_t prepare(int q, bool grouped, TilesFn<T>* kernel) {
  const int v = q > QC ? 0 : q > 8 || sizeof(T) == 4 ? 2 : 1;
  *kernel = grouped ? pick<T, true>(v) : pick<T, false>(v);
  static bool ready[64][3][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][v][grouped]) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(smem_elems<T>() * sizeof(T)));
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][v][grouped] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaLaunchConfig_t config(int clusters, int cs, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_elems<T>() * sizeof(T);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the variant for m and q that the card holds at once.
template <typename T>
int max_clusters(int m, int q, int* out) {
  const int mp = (m + BC - 1) / BC * BC;
  TilesFn<T> kernel;
  cudaError_t err = prepare<T>(q, mp / BC > CMAX, &kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const int cs = cluster_size(mp);
  cudaLaunchConfig_t cfg = config<T>(1, cs, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

template <typename T>
int launch(const T* x, const T* y, const T* w, const T* zp, const T* sp,
           const T* gcp, const T* hp, int n, int m, int q, int d, int mp,
           int n_slices, int tiles_per_slice, int flags, double* part_z,
           double* part_ell, double* part_sf2, double* dz, double* dell,
           double* dsf2, T* rp_x, T* rp_y, T* rp_w, T* dx, T* dy, T* dw,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TilesFn<T> kernel;
  cudaError_t err = prepare<T>(q, mp / BC > CMAX, &kernel);
  if (err != cudaSuccess) return err;
  const int cs = cluster_size(mp);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<T>(n_slices, cs, s, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, cs,
                           tiles_per_slice, flags, part_z, part_ell, part_sf2, rp_x,
                           rp_y, rp_w);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * q > q ? (long)m * q : q;
  total = total > 1 ? total : 1;
  reg_stats_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_z, part_ell, part_sf2, n_slices, n_slices * cs, m, q, mp, dz, dell, dsf2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long rows = ((flags & 1) ? (long)n * q : 0) + ((flags & 2) ? (long)n * d : 0)
                    + ((flags & 4) ? n : 0);
  if (rows > 0) {
    reg_stats_bwd_rows<T><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
        rp_x, rp_y, rp_w, w, hp, n, q, d, cs, flags, dx, dy, dw);
    err = cudaGetLastError();
  }
  return err;
}

static_assert(smem_elems<double>() * sizeof(double) <= 232448 - 512,
              "f64 block over sm_90's 227 KB beside the exp table");
static_assert(smem_elems<float>() * sizeof(float) <= 232448 / 2 - 512,
              "two f32 blocks an SM, each beside the exp table");

}  // namespace

// x (n, q), y (n, d), w (n,): the forward's inputs.  zp (mp, q), sp (mp,
// mp) = gD + gD^T, gcp (mp, d): zero past m, mp = 128 ceil(m / 128).  hp =
// [sf2, sf2 gb, 1/ell^2 (q)].  n_slices clusters of cs = min(mp / 128, 8)
// blocks, each a slice of tiles_per_slice 64-row tiles (at least one
// slice).  Scratch (f64): part_z (n_slices, mp, q), part_ell (n_slices cs,
// q), part_sf2 (n_slices cs); in the input dtype, when flags asks (1, 2,
// 4), the row partials rp_x (cs, n, q), rp_y (cs, n, d), rp_w (cs, n).
// Outputs (f64): dz (m, q), dell (q), dsf2 (), the latter without gb b;
// when flags asks, dx (n, q), dy (n, d), dw (n) in the input dtype.  Any
// m, q and d: shared memory is fixed.  Returns cudaGetLastError().
// reg_stats_bwd_clusters_*: the clusters of the variant for (m, q) the
// card holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int reg_stats_bwd_f64(const double* x, const double* y, const double* w,
                                 const double* zp, const double* sp,
                                 const double* gcp, const double* hp, int n,
                                 int m, int q, int d, int mp, int n_slices,
                                 int tiles_per_slice, int flags, double* part_z,
                                 double* part_ell, double* part_sf2, double* dz,
                                 double* dell, double* dsf2, double* rp_x,
                                 double* rp_y, double* rp_w, double* dx,
                                 double* dy, double* dw, void* stream) {
  return launch<double>(x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, n_slices,
                        tiles_per_slice, flags, part_z, part_ell, part_sf2, dz,
                        dell, dsf2, rp_x, rp_y, rp_w, dx, dy, dw, stream);
}

extern "C" int reg_stats_bwd_f32(const float* x, const float* y, const float* w,
                                 const float* zp, const float* sp,
                                 const float* gcp, const float* hp, int n,
                                 int m, int q, int d, int mp, int n_slices,
                                 int tiles_per_slice, int flags, double* part_z,
                                 double* part_ell, double* part_sf2, double* dz,
                                 double* dell, double* dsf2, float* rp_x,
                                 float* rp_y, float* rp_w, float* dx,
                                 float* dy, float* dw, void* stream) {
  return launch<float>(x, y, w, zp, sp, gcp, hp, n, m, q, d, mp, n_slices,
                       tiles_per_slice, flags, part_z, part_ell, part_sf2, dz,
                       dell, dsf2, rp_x, rp_y, rp_w, dx, dy, dw, stream);
}

extern "C" int reg_stats_bwd_clusters_f64(int m, int q, int* out) {
  return max_clusters<double>(m, q, out);
}

extern "C" int reg_stats_bwd_clusters_f32(int m, int q, int* out) {
  return max_clusters<float>(m, q, out);
}
