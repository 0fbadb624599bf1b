// Fused regression map step for Hopper (sm_90a): the SGPR statistics
//
//     b = sf2 * sum_i w_i                    ()
//     C = knm^T (w . Y)                      (m, d)
//     D = (knm . w)^T knm                    (m, m)
//
// with knm[i, a] = sf2 * exp(-1/2 sum_q (x_iq - z_aq)^2 / ell_q^2), built
// tile by tile in shared memory and never stored whole.
//
// Replaces the TPU kernel src/repro/kernels/reg_stats/kernel.py:99,
// reg_stats_pallas (body _reg_stats_kernel, pallas_call at :112), forward
// only.
//
// What bounds it on the H100: operations.  D alone is n*m*(m+1)/2
// multiply-adds (2.6e11 at n = 1e6, m = 512) against ~52 MB of input, far
// above the card's balance point; the slab costs q distance FMAs and one
// exp per (row, column) it is built for.  Shared by all three kernels:
//   * The TPU carries the D/C/b accumulators from one step of a sequential
//     n-grid to the next.  Here blocks run in parallel and in no order, so
//     the rows are cut into slices; each slice's partials are summed by a
//     second small kernel in a fixed order (slice 0, 1, ...) in f64, which
//     also mirrors D (only the upper triangle is computed): no atomics, so
//     results are bitwise repeatable, and splitting n keeps the error of a
//     1e6-row sum small.  Within a slice, the accumulators are folded into
//     the block's partial every 4,096 rows with Kahan compensation.
//   * The exponent is evaluated directly as sum_q (x_q - z_q)^2 * inv_q
//     (q FMAs per entry).  The Pallas kernel's expanded form alpha + M.Zc is
//     not anchored and cancels in f32 for inputs with large offsets; the
//     direct form has no such cancellation and costs little at q = 8.
//   * Ragged edges are masked, never padded into the result: rows past n
//     (or past the slice) carry w = 0 and x = y = 0; inducing points past m
//     carry z = 0 and are never written out.  No result depends on the
//     tile size.
//   * Shared memory is fixed whatever q and d (features staged 16 at a
//     time or read from device memory past that, y and C 8 columns wide or
//     in device memory past that), and the work units go on gridDim.x, so
//     no q, d or m is refused.
//
// f64 (what the f64 models call): D on the FP64 tensor cores (mma.sync
// f64, DMMA: IEEE f64; Hopper has no f64 wgmma).  At m <= 512 (every config
// of the repo) the cluster kernel; past that the per-tile kernel.
//   * What bounded the per-tile design (the f64 kernel before the
//     cluster kernel): each block built the slabs
//     of its own 128 x 128 upper tile, so each knm entry was built m/128
//     times over the grid (4 at m = 512), and that build (q distance FMAs
//     and a libdevice exp an entry, on the FP64 CUDA cores) took as long
//     as the product; the diagonal tiles, with one slab, waited.
//   * Why not "a block a 128-column tile, its upper tiles dealt over the
//     cluster": D's accumulators must stay in registers across the rows
//     (folding a tile out of registers every chunk costs more L2 traffic
//     than the product), and at m = 512 the upper triangle, 131,328
//     entries, is more than 4 SMs' registers hold.  Eight SMs hold 8 x 256
//     threads x 64 accumulators = 131,072 entries: just short of the
//     triangle with its diagonal, enough without the 64 diagonal 8 x 8
//     blocks.  So:
//   * The cluster kernel: a thread-block cluster of nb = ceil(m/64) blocks
//     (at most 8) takes one slice of rows.  Block r builds knm of each
//     32-row chunk against its own band of 64 inducing points, once, into
//     its shared memory (three buffers: chunk c is multiplied while c+2 is
//     built and c+1 is copied).  D's upper triangle is cut into nb^2 warp
//     tasks of 16 fragments each: the 64 x 32 regions of the band pairs
//     (lo < hi: A = band lo, B = a half of band hi weighted by w), and
//     each band's staircase (the 16 fragments of its own 64 x 64 block
//     strictly above its diagonal 8 x 8 blocks).  Rank h takes its own
//     staircase and the pairs (h, h + 1 .. h + (nb-1)/2 mod nb), both
//     halves, and for even nb one half of (h, h + nb/2): every block the
//     same number of fragments (nb x 16), every warp at most 16, and at
//     most 4 other bands to copy.  The other bands of a chunk come through
//     distributed shared memory (ld.shared::cluster, one copy a chunk into
//     a local buffer), never rebuilt.  Each warp also takes one diagonal
//     8 x 8 block of its own band and its C rows (mma.sync m8n8k4 f64, A =
//     w knm, B = knm or y), so D's diagonal and C come from the block that
//     built them.  One cluster barrier a chunk, its wait after the chunk's
//     first product part.  kernels/reg_stats/kernel.py::cluster_plan is
//     the plan; the blocks read it.
//   * The products take sm_90's m16n8k8 f64 shape (8 rows an instruction):
//     12.77 ms against 13.71 with m16n8k4 (H100 80GB HBM3, 700 W,
//     tools/bwd_ablation.py-style variants, one call).
//   * The build: q <= 8 and q <= 16 are instantiations whose feature loop
//     is unrolled without a guard (x, z and 1/ell^2 zero past q, x's rows
//     staged KQ wide), four chains a thread side by side, the exp
//     psi_stats.cu's branch-free exp_pair (its table in shared memory).
//     With a guard on q and two chains the build cost 5.1-5.5 ms of 16.0,
//     latency-bound; now 2.1-2.3 ms.  Past 16 features x and z come from
//     device memory.
//   * Measured (the ablation tool's --kernel reg_stats_fwd, device ms at
//     sgpr-synth-1m): 12.78-12.90 against the per-tile design's 16.78;
//     without the build 10.5-10.7, without the products 8.6, without the
//     copies 11.4-11.6, without the cluster barrier 11.9-12.1, the products
//     and the frame alone 9.3-9.5.  15 clusters of 8 fit the card (120 of
//     132 SMs).  The DMMA loop runs at about half of its peak: with two
//     warps a sub-partition, the barriers and the build's and copies'
//     latency stall it; build and product do not overlap.
//   * Tried and dropped (same tool, same card): the two warps of an SM
//     sub-partition building and multiplying in opposite order (16.46
//     against 15.84 in the same phase); x and z in units of ell, two
//     FP64 ops a distance term (13.08 against 12.78); libdevice's exp in
//     place of exp_pair (equal within 1%).
//   * Shared memory is fixed (CLUSTER_SMEM_BYTES): x staged by cp.async
//     (four buffers, three chunks ahead) when q <= QC = 16; y staged DC = 8
//     columns wide and C on DMMA when d <= 8, else C on the CUDA cores into
//     the block's rows of part_c with y from device memory.
//   * Past 512 points (nb > 8) the per-tile kernel: one block an (n-slice,
//     upper 128-tile) unit on gridDim.x (unit = slice * tiles + tile; C on
//     the diagonal tiles, b on tile 0), each building the slabs of its two
//     column tiles (libdevice exp), 8 warps of 64 x 32 m16n8k4 fragments,
//     the next chunk's slabs built while this one's are multiplied, x and w
//     by cp.async in three buffers; z, x and 1/ell^2 staged 16 features at
//     a time (past that the exponent sums accumulate in the slab buffers,
//     without the overlap), y and C's rows 8 columns wide (past that in
//     part_c).
//
// f32 (the TPU kernel's f32 contract): the per-tile kernel's structure with
// the product in IEEE f32 on the CUDA cores (TF32 misses the f32 tier), so the product
// (n*m*(m+1)/2 FMAs, 1.3e11 at sgpr-synth-1m) and the slab build share the
// FP32 pipe, and that pipe is the bound, with shared memory's delivery
// beside it (an 8 x 8 tile reads a byte per FMA).  On the H100 the two
// barely overlap: without the build 8.8 ms of 13.6, without the product
// 5.4; the product runs at 18.6 TFMA/s, cuBLAS's f32 at 24.3 (PERF.md).
//   * 128 x 128 upper tiles under fill_plan, two blocks per SM (at most 128
//     registers a thread, 16 warps an SM: 8% faster than one block of 167
//     registers), so each slab entry is built m/128 times; a diagonal
//     tile's slab once.
//   * An 8 x 8 micro-tile per thread: per slab row two float4 reads of each
//     slab (conflict-free) for 64 FMAs, where 4 x 4 micro-tiles read twice
//     the bytes per FMA and kept the loop at shared memory's rate.
//   * The exponent in the direct form, -1/2 log2(e) folded into the staged
//     1/ell^2 by the wrapper, and one ex2.approx per entry on the SFU (about
//     2^-22 relative, far inside the tier; libdevice's expf is ~8 FP32 ops).
//   * The f64 per-tile kernel's overlap (double-buffered slabs, cp.async
//     rows in three buffers, one barrier a chunk) and its Kahan fold every 4,096
//     rows into the block's scratch in L2 (a fold per chunk in registers
//     cost 4 ops per accumulator a chunk and 32 registers a thread).
//   * Fixed shared memory (FMA_SMEM_BYTES), whatever q and d, as in f64.
// At sgpr-synth-1m, f32 tiles move the served mean far outside its budget,
// and f32 outputs make I + beta L^-1 D L^-T indefinite, because Sigma = Kmm +
// beta*D is ill-conditioned (ROADMAP Queue 3), so f64 callers get the
// double instantiation; no main path launches this one.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/reg_stats/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Fixed-order f64 sum of the per-slice partials; D's lower half mirrors
// the upper tiles, so D is exactly symmetric.
template <typename T, int TILE>
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
    const int ta = lo / TILE, tb = hi / TILE;
    const long tile = (long)ta * nts - (long)ta * (ta - 1) / 2 + (tb - ta);
    const size_t off = (size_t)tile * TILE * TILE + (lo % TILE) * TILE + hi % TILE;
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl)
      s += part_d[(size_t)sl * n_tiles * TILE * TILE + off];
    D[e] = s;
  }
  if (e < (long)m * d) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl)
      s += part_c[(size_t)sl * nts * TILE * d + e];
    C[e] = s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_b[sl];
    *b = s;
  }
}

// ---------------------------------------------------------------------------
// f64: DMMA
// ---------------------------------------------------------------------------

constexpr int DT = 128;          // D tile edge
constexpr int DRC = 32;          // rows per chunk
constexpr int DNT = 256;         // 8 warps: 2 x 4 warp tiles of 64 x 32
constexpr int LDK = DT + 4;      // slab row stride (doubles): no bank conflicts
constexpr int QC = 16;           // features of z, x and 1/ell^2 staged at a time
constexpr int DC = 8;            // y columns staged, C columns held, when d <= DC
constexpr int BG = 8;            // slab rows per build group
constexpr int FOLD_CHUNKS = 128; // chunks (4,096 rows) between Kahan folds

// c (16 x 8) += a (16 x 4) b (4 x 8) in f64.  Lane l holds a[l/4][l%4] and
// a[l/4 + 8][l%4], b[l%4][l/4], c[l/4 (+8)][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// 8 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Shared memory of one block, whatever q and d: double-buffered slabs, one
// q-chunk of z for both tile sides and of 1/ell^2, three buffers of one
// q-chunk of x rows, of DC columns of y rows and of w, DC columns of C.
constexpr size_t DMMA_SMEM_BYTES =
    sizeof(double) * (2 * 2 * DRC * LDK + 2 * QC * DT + 3 * DRC * QC
                      + 3 * DRC * DC + 3 * DRC + QC + DT * DC);
static_assert(DMMA_SMEM_BYTES <= 232448, "f64 block over sm_90's 227 KB");

// CHUNKED = false (q <= QC): z and 1/ell^2 are staged once, x and w stream
// in through cp.async, and the next chunk's slab build is interleaved with
// this chunk's product.  CHUNKED = true (q > QC): for each chunk, the
// exponent sums are accumulated in the slab buffers over q-chunks of z, x
// and 1/ell^2 staged in turn, exponentiated and weighted in place after the
// last one, then multiplied; nothing overlaps.  A diagonal block's C rows
// accumulate in shared memory from y rows streamed beside x when d <= DC
// and q <= QC; otherwise in the block's own rows of part_c, with y read
// from device memory.  Shared memory depends on neither q nor d.
template <bool CHUNKED>
__global__ void __launch_bounds__(DNT, 1)
reg_stats_dmma(const double* __restrict__ x, const double* __restrict__ y,
               const double* __restrict__ w, const double* __restrict__ z,
               const double* __restrict__ hp, int n, int m, int q, int d,
               int rows_per_slice, int nts, double* __restrict__ part_d,
               double* __restrict__ part_comp, double* __restrict__ part_c,
               double* __restrict__ part_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* slabs = reinterpret_cast<double*>(smem_raw);  // [2][2][DRC][LDK]
  double* zaT = slabs + 4 * DRC * LDK;                  // [QC][DT]
  double* zbT = zaT + QC * DT;                          // [QC][DT]
  double* xs = zbT + QC * DT;                           // [3][DRC * QC]
  double* ys = xs + 3 * DRC * QC;                       // [3][DRC * DC]
  double* ws = ys + 3 * DRC * DC;                       // [3][DRC]
  double* inv = ws + 3 * DRC;                           // [QC]
  double* cacc = inv + QC;                              // [DT][DC]

  const int n_tiles = nts * (nts + 1) / 2;
  const int slice = (int)blockIdx.x / n_tiles, tile = (int)blockIdx.x % n_tiles;
  int a = 0, rem = tile;
  while (rem >= nts - a) {
    rem -= nts - a;
    ++a;
  }
  const int b = a + rem;
  const bool diag = a == b;
  const int a0 = a * DT, b0 = b * DT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int i0 = (warp / 4) * 64, j0 = (warp % 4) * 32;
  const double sf2 = hp[0];

  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  const int n_chunks = hi > lo ? (int)((hi - lo + DRC - 1) / DRC) : 0;
  // This slice's C rows of the tile, owned by the diagonal block: each
  // entry is accumulated by one thread, no atomics, in shared memory
  // (staged_y) or in part_c.
  const bool staged_y = !CHUNKED && d <= DC;
  double* pc = part_c + ((size_t)slice * nts * DT + a0) * d;
  if (diag)
    for (int e = tid; e < DT * d; e += DNT) (staged_y ? cacc : pc)[e] = 0.0;

  // z of both tile sides and 1/ell^2, features [k0, k0 + kw)
  auto stage_z = [&](int k0, int kw) {
    for (int e = tid; e < kw; e += DNT) inv[e] = hp[1 + k0 + e];
    for (int e = tid; e < kw * DT; e += DNT) {
      const int k = e / DT, i = e % DT;
      zaT[e] = a0 + i < m ? z[(size_t)(a0 + i) * q + k0 + k] : 0.0;
      zbT[e] = b0 + i < m ? z[(size_t)(b0 + i) * q + k0 + k] : 0.0;
    }
  };
  // x, w (and y when staged) of chunk c into buffer c % 3, rows past the
  // slice zero-filled (q <= QC: a chunk's rows are contiguous)
  auto issue = [&](int c) {
    if (c >= n_chunks) return;
    const long r0 = lo + (long)c * DRC;
    const int bf = c % 3;
    const long xlim = (hi - r0) * q, ylim = (hi - r0) * d;
    for (int e = tid; e < DRC * q; e += DNT)
      cp_async8(xs + bf * DRC * QC + e, e < xlim ? x + r0 * q + e : x,
                e < xlim);
    if (staged_y)
      for (int e = tid; e < DRC * d; e += DNT)
        cp_async8(ys + bf * DRC * DC + e, e < ylim ? y + r0 * d + e : y,
                  e < ylim);
    for (int e = tid; e < DRC; e += DNT)
      cp_async8(ws + bf * DRC + e, r0 + e < hi ? w + r0 + e : w, r0 + e < hi);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Rows [g*BG, g*BG + BG) of the slabs aw = w * ka and bs = kb (kb = ka on
  // a diagonal tile) over the kw staged features, x rows from xb (row
  // stride xld).  The exponent sums start at 0 (first) or at the partial
  // sums stored in the slabs, and are exponentiated and weighted (last) or
  // stored back.  Each thread owns one column i of its half of the rows
  // and takes BG/2 rows at a time, so each z and 1/ell^2 it loads serves
  // several rows.
  auto build = [&](double* aw, double* bs, const double* xb, int xld,
                   const double* wb, int g, int kw, bool first, bool last) {
    const int i = tid % DT, r0 = g * BG + (tid / DT) * (BG / 2);
    double sa[BG / 2], sb[BG / 2];
#pragma unroll
    for (int u = 0; u < BG / 2; ++u) {
      sa[u] = first ? 0.0 : aw[(r0 + u) * LDK + i];
      sb[u] = first || diag ? 0.0 : bs[(r0 + u) * LDK + i];
    }
    for (int k = 0; k < kw; ++k) {
      const double za = zaT[k * DT + i], zb = zbT[k * DT + i], iv = inv[k];
#pragma unroll
      for (int u = 0; u < BG / 2; ++u) {
        const double xv = xb[(r0 + u) * xld + k];
        const double da = xv - za;
        sa[u] = fma(da * da, iv, sa[u]);
        if (!diag) {
          const double db = xv - zb;
          sb[u] = fma(db * db, iv, sb[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BG / 2; ++u) {
      const int r = r0 + u;
      if (last) {
        const double ka = sf2 * exp(-0.5 * sa[u]);
        aw[r * LDK + i] = wb[r] * ka;
        bs[r * LDK + i] = diag ? ka : sf2 * exp(-0.5 * sb[u]);
      } else {
        aw[r * LDK + i] = sa[u];
        if (!diag) bs[r * LDK + i] = sb[u];
      }
    }
  };

  double acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
  // Rows [g*BG, g*BG + BG) of a chunk's product acc += aw^T bs on the
  // tensor cores.
  auto product = [&](const double* aw, const double* bs, int g) {
#pragma unroll
    for (int kk = g * BG / 4; kk < (g + 1) * BG / 4; ++kk) {
      const int r = 4 * kk + tig;
      double af[4][2], bf[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        af[mt][0] = aw[r * LDK + i0 + mt * 16 + gid];
        af[mt][1] = aw[r * LDK + i0 + mt * 16 + gid + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bf[nt] = bs[r * LDK + j0 + nt * 8 + gid];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], af[mt], bf[nt]);
    }
  };

  bool first_fold = true;
  double* pd = part_d + (size_t)blockIdx.x * DT * DT;
  double* pk = part_comp + (size_t)blockIdx.x * DT * DT;
  // Kahan: running tile += acc; acc = 0.  Each entry has one owner thread.
  auto fold = [&]() {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + mt * 16 + gid + 8 * (e >> 1);
          const int j = j0 + nt * 8 + 2 * tig + (e & 1);
          const size_t o = (size_t)i * DT + j;
          double tv = acc[mt][nt][e], comp = 0.0;
          if (!first_fold) {
            const double tot = pd[o];
            const double yv = acc[mt][nt][e] - pk[o];
            tv = tot + yv;
            comp = (tv - tot) - yv;
          }
          pd[o] = tv;
          pk[o] = comp;
          acc[mt][nt][e] = 0.0;
        }
    first_fold = false;
  };

  double wsum = 0.0;
  // After chunk c's product: its C rows (diagonal tile) and its sum of w,
  // then the Kahan fold every FOLD_CHUNKS chunks.
  auto finish = [&](int c, const double* aw, const double* wb) {
    if (diag && staged_y) {
      const double* yb = ys + (c % 3) * DRC * DC;
      for (int e = tid; e < DT * d; e += DNT) {
        const int i = e / d, cc = e % d;
        double s = 0.0;
        for (int r = 0; r < DRC; ++r) s = fma(aw[r * LDK + i], yb[r * d + cc], s);
        cacc[e] += s;
      }
    } else if (diag) {
      const long r0 = lo + (long)c * DRC;
      const int nr = (int)min((long)DRC, hi - r0);
      for (int e = tid; e < DT * d; e += DNT) {
        const int i = e / d, cc = e % d;
        double s = 0.0;
        for (int r = 0; r < nr; ++r) s = fma(aw[r * LDK + i], y[(r0 + r) * d + cc], s);
        pc[e] += s;
      }
    }
    if (tile == 0 && tid == 0) {
      double s = 0.0;
      for (int r = 0; r < DRC; ++r) s += wb[r];
      wsum += s;
    }
    if ((c + 1) % FOLD_CHUNKS == 0 || c + 1 == n_chunks) fold();
  };

  if constexpr (!CHUNKED) {
    stage_z(0, q);
    issue(0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // z, 1/ell^2, chunk 0's rows
    issue(1);
    if (n_chunks > 0)
      for (int g = 0; g < DRC / BG; ++g)
        build(slabs, slabs + DRC * LDK, xs, q, ws, g, q, true, true);

    for (int c = 0; c < n_chunks; ++c) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // chunk c's slabs and chunk c+1's rows are in; c-1 is done
      issue(c + 2);

      // This chunk's product on the tensor cores, interleaved with the next
      // chunk's slab build on the CUDA cores (the other slab buffer).
      const double* aw = slabs + (c & 1) * 2 * DRC * LDK;
      double* nxt = slabs + ((c + 1) & 1) * 2 * DRC * LDK;
      const int nb = (c + 1) % 3;
#pragma unroll
      for (int g = 0; g < DRC / BG; ++g) {
        product(aw, aw + DRC * LDK, g);
        if (c + 1 < n_chunks)
          build(nxt, nxt + DRC * LDK, xs + nb * DRC * QC, q, ws + nb * DRC,
                g, q, true, true);
      }
      finish(c, aw, ws + (c % 3) * DRC);
    }
  } else {
    double* aw = slabs;
    double* bs = slabs + DRC * LDK;
    for (int c = 0; c < n_chunks; ++c) {
      const long r0 = lo + (long)c * DRC;
      for (int k0 = 0; k0 < q; k0 += QC) {
        const int kw = min(QC, q - k0);
        __syncthreads();  // the staged features and the slabs are free
        stage_z(k0, kw);
        for (int e = tid; e < DRC * kw; e += DNT) {
          const int r = e / kw, k = e % kw;
          xs[r * QC + k] = r0 + r < hi ? x[(r0 + r) * q + k0 + k] : 0.0;
        }
        if (k0 == 0)
          for (int e = tid; e < DRC; e += DNT)
            ws[e] = r0 + e < hi ? w[r0 + e] : 0.0;
        __syncthreads();
        for (int g = 0; g < DRC / BG; ++g)
          build(aw, bs, xs, QC, ws, g, kw, k0 == 0, k0 + QC >= q);
      }
      __syncthreads();  // the chunk's slabs are complete
#pragma unroll
      for (int g = 0; g < DRC / BG; ++g) product(aw, bs, g);
      finish(c, aw, ws);
    }
  }
  if (n_chunks == 0) fold();  // an empty slice writes zeros

  if (diag && staged_y)
    for (int e = tid; e < DT * d; e += DNT) pc[e] = cacc[e];
  if (tile == 0 && tid == 0) part_b[slice] = sf2 * wsum;
}

int launch_f64(const double* x, const double* y, const double* w,
               const double* z, const double* hp, int n, int m, int q, int d,
               int n_slices, int rows_per_slice, double* part_d,
               double* part_comp, double* part_c, double* part_b, double* D,
               double* C, double* b, void* stream) {
  const int nts = (m + DT - 1) / DT;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = q <= QC ? reg_stats_dmma<false> : reg_stats_dmma<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DMMA_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(n_tiles * n_slices), DNT, DMMA_SMEM_BYTES, s>>>(
      x, y, w, z, hp, n, m, q, d, rows_per_slice, nts, part_d, part_comp,
      part_c, part_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * m > (long)m * d ? (long)m * m : (long)m * d;
  if (total < 1) total = 1;
  reg_stats_reduce<double, DT><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_d, part_c, part_b, n_slices, nts, m, d, D, C, b);
  return cudaGetLastError();
}
// ---------------------------------------------------------------------------
// f64, m <= 512: one cluster a row slice, each knm entry built once
// ---------------------------------------------------------------------------

constexpr int BW = 64;           // inducing points a band (one band a block)
constexpr int CR = 32;           // rows a chunk
constexpr int LDB = BW + 4;      // band row stride (doubles): 4 mod 16, so the
                                 // DMMA fragments' loads hit distinct banks
constexpr int NR = 4;            // other blocks' bands a block copies, at most
constexpr int NBMAX = 8;         // bands, i.e. blocks a cluster, at most
constexpr int XS = 4;            // staging buffers of x, y, w: chunks c .. c+3
constexpr int GRP = 4;           // parts of a chunk's work interleaved
constexpr int TASK = 6;          // ints of one warp's task in the plan
constexpr int PLAN = NR + TASK * (DNT / 32);  // ints of one rank's plan

// Shared memory of one cluster block, whatever q and d: its band of three
// chunks, the copied bands of two, x (QC columns), y (DC) and w of XS
// chunks, z of its band and 1/ell^2 (QC features).
constexpr size_t CLUSTER_SMEM_BYTES =
    sizeof(double) * (3 * CR * LDB + 2 * NR * CR * LDB + XS * CR * QC
                      + XS * CR * DC + XS * CR + QC * BW + QC);
static_assert(CLUSTER_SMEM_BYTES + 512 <= 232448,
              "cluster block over sm_90's 227 KB beside the exp table");

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

// sf2 exp(-1/2 e), e = sum_q (x_q - z_q)^2 / ell_q^2: psi_stats.cu's
// branch-free exp_pair (so a thread's chains interleave; its error one
// rounding beyond a 4e-18 polynomial), the table tab staged in shared
// memory.
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

// c (8 x 8) += a (8 x 4) b (4 x 8) in f64.  Lane l holds a[l/4][l%4],
// b[l%4][l/4], c[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma8(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// The cluster: this block's rank, the barrier's two halves (arrive with
// release, wait with acquire: shared memory written before an arrive is
// seen by every block of the cluster after the wait), a local shared
// address mapped to the same offset in block `rank`, and a 16-byte load
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

// The staircase's fragment s (0..15) of a band's own 64 x 64 block: row
// fragment i (16 points), column fragment j (8 points), j >= 2i + 1, the
// part strictly above the block's diagonal 8 x 8 blocks.
__host__ __device__ constexpr int stair_i(int s) {
  return s < 7 ? 0 : s < 12 ? 1 : s < 15 ? 2 : 3;
}
__host__ __device__ constexpr int stair_j(int s) {
  return s < 7 ? s + 1 : s < 12 ? s - 4 : s < 15 ? s - 7 : 7;
}

// c (16 x 8) += a (16 x 8) b (8 x 8) in f64 (sm_90's k = 8 shape: half the
// instructions of two m16n8k4).  Lane l holds a[l/4 + 8 (i % 2)][l%4 + 4
// (i / 2)] in a[i], b[l%4 + 4 i][l/4] in b[i], c as m16n8k4's.
__device__ __forceinline__ void dmma_k8(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One k-step of 8 rows (chunk rows 8 k8 .. 8 k8 + 7) of a 64 x 32 region:
// A the 64 points of the band at as, B the 32 points at bs times the rows'
// w (wb).  acc[mt * 4 + nt] is fragment (mt, nt).
__device__ __forceinline__ void rect_step(double (&acc)[16][4], const double* as,
                                          const double* bs, int k8, const double* wb,
                                          int gid, int tig) {
  const int r0 = 8 * k8 + tig, r1 = r0 + 4;
  const double w0 = wb[r0], w1 = wb[r1];
  double af[4][4], bf[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    af[mt][0] = as[r0 * LDB + mt * 16 + gid];
    af[mt][1] = as[r0 * LDB + mt * 16 + gid + 8];
    af[mt][2] = as[r1 * LDB + mt * 16 + gid];
    af[mt][3] = as[r1 * LDB + mt * 16 + gid + 8];
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bf[nt][0] = bs[r0 * LDB + nt * 8 + gid] * w0;
    bf[nt][1] = bs[r1 * LDB + nt * 8 + gid] * w1;
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) dmma_k8(acc[mt * 4 + nt], af[mt], bf[nt]);
}

// One 8-row k-step of a band's staircase (its 16 fragments), A and B the
// band.
__device__ __forceinline__ void stair_step(double (&acc)[16][4], const double* bs,
                                           int k8, const double* wb, int gid, int tig) {
  const int r0 = 8 * k8 + tig, r1 = r0 + 4;
  const double w0 = wb[r0], w1 = wb[r1];
  double af[4][4], bf[8][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    af[mt][0] = bs[r0 * LDB + mt * 16 + gid];
    af[mt][1] = bs[r0 * LDB + mt * 16 + gid + 8];
    af[mt][2] = bs[r1 * LDB + mt * 16 + gid];
    af[mt][3] = bs[r1 * LDB + mt * 16 + gid + 8];
  }
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    bf[j][0] = bs[r0 * LDB + j * 8 + gid] * w0;
    bf[j][1] = bs[r1 * LDB + j * 8 + gid] * w1;
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) dmma_k8(acc[s], af[stair_i(s)], bf[stair_j(s)]);
}

// One cluster of nb blocks takes the rows [slice * rows_per_slice, ...);
// block (rank) h builds band h (inducing points 64 h .. 64 h + 63) and runs
// the tasks plan[h] gives its warps: (kind: 0 none, 1 region, 2
// staircase; A's slot, B's slot (0: its own band, s: its copy of band
// plan[h][s - 1]), B's first column (0 or 32), the partial's task slot,
// its first column).  Partials (f64): part_d / part_comp (slices, nb (nb +
// 1) / 2 task slots, 64, 64): slot t < nb band t's staircase, nb +
// pair(lo, hi) the pair's two regions; part_g / part_gcomp (slices, nb *
// 8, 8, 8) the diagonal 8 x 8 blocks; part_c (slices, nb * 64, d), part_b
// (slices).
template <int KQ>
__global__ void __launch_bounds__(DNT, 1)
reg_stats_cluster(const double* __restrict__ x, const double* __restrict__ y,
                  const double* __restrict__ w, const double* __restrict__ z,
                  const double* __restrict__ hp, int n, int m, int q, int d,
                  int nb, int rows_per_slice, const int* __restrict__ plan,
                  double* __restrict__ part_d, double* __restrict__ part_comp,
                  double* __restrict__ part_g, double* __restrict__ part_gcomp,
                  double* __restrict__ part_c, double* __restrict__ part_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* own = reinterpret_cast<double*>(smem_raw);  // [3][CR][LDB]  the own band
  double* cps = own + 3 * CR * LDB;                   // [2][NR][CR][LDB] copies
  double* xs = cps + 2 * NR * CR * LDB;               // [XS][CR * QC]
  double* ys = xs + XS * CR * QC;                     // [XS][CR * DC]
  double* ws = ys + XS * CR * DC;                     // [XS][CR]
  double* zT = ws + XS * CR;                          // [QC][BW]
  double* inv = zT + QC * BW;                         // [QC]
  __shared__ double e2f[64];                          // kExp2Frac

  constexpr bool CHUNKED = KQ == 0;  // past QC features: x and z from device memory
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int slice = (int)blockIdx.x / nb, rank = cluster_rank();
  const int p0 = rank * BW;
  const int n_tasks = nb * (nb + 1) / 2;
  const double sf2 = hp[0];
  const int* pl = plan + rank * PLAN;
  int cr[NR];
#pragma unroll
  for (int s = 0; s < NR; ++s) cr[s] = pl[s];
  const int* tk = pl + NR + warp * TASK;
  const int kind = tk[0], a_slot = tk[1], b_slot = tk[2], b_col = tk[3];
  const int out_task = tk[4], out_col = tk[5];

  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  const int n_chunks = hi > lo ? (int)((hi - lo + CR - 1) / CR) : 0;
  const bool staged_y = d <= DC;
  double* pc = part_c + ((size_t)slice * nb * BW + p0) * d;
  if (!staged_y)
    for (int e = tid; e < BW * d; e += DNT) pc[e] = 0.0;
  if (!CHUNKED) {
    // KQ features, zero past q (1/ell^2 too), x's rows KQ wide: the
    // build's feature loop needs no guard.
    for (int e = tid; e < KQ; e += DNT) inv[e] = e < q ? hp[1 + e] : 0.0;
    for (int e = tid; e < KQ * BW; e += DNT) {
      const int k = e / BW, i = e % BW;
      zT[e] = p0 + i < m && k < q ? z[(size_t)(p0 + i) * q + k] : 0.0;
    }
    for (int e = tid; e < XS * CR * QC; e += DNT) xs[e] = 0.0;
    __syncthreads();  // the zeros are in before cp.async fills the rows
  }

  // x (q <= QC, rows KQ wide), y (d <= DC) and w of chunk c into buffer
  // c % XS, rows past the slice zero-filled
  auto issue = [&](int c) {
    if (c >= n_chunks) return;
    const long r0 = lo + (long)c * CR;
    const int bf = c % XS;
    const long xlim = (hi - r0) * q, ylim = (hi - r0) * d;
    if (!CHUNKED)
      for (int e = tid; e < CR * q; e += DNT)
        cp_async8(xs + bf * CR * QC + e / q * KQ + e % q, e < xlim ? x + r0 * q + e : x,
                  e < xlim);
    if (staged_y)
      for (int e = tid; e < CR * d; e += DNT)
        cp_async8(ys + bf * CR * DC + e, e < ylim ? y + r0 * d + e : y, e < ylim);
    for (int e = tid; e < CR; e += DNT)
      cp_async8(ws + bf * CR + e, r0 + e < hi ? w + r0 + e : w, r0 + e < hi);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Half h of chunk c's band: point i = tid % 64, rows 8 (tid / 64) + 4 h
  // + {0..3}, the four chains side by side (KQ features, unguarded).
  auto build = [&](int c, int h) {
    double* ob = own + (c % 3) * CR * LDB;
    const int i = tid % BW, rb = (tid / BW) * 8 + 4 * h;
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    if constexpr (!CHUNKED) {
      const double* xb = xs + (c % XS) * CR * QC + rb * KQ;
#pragma unroll
      for (int k = 0; k < KQ; ++k) {
        const double zk = zT[k * BW + i], iv = inv[k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const double dv = xb[u * KQ + k] - zk;
          s[u] = fma(dv * dv, iv, s[u]);
        }
      }
    } else {
      const long r0 = lo + (long)c * CR + rb;
      for (int k = 0; k < q; ++k) {
        const double zk = p0 + i < m ? z[(size_t)(p0 + i) * q + k] : 0.0;
        const double iv = hp[1 + k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const double dv = (r0 + u < hi ? x[(r0 + u) * q + k] : 0.0) - zk;
          s[u] = fma(dv * dv, iv, s[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) ob[(rb + u) * LDB + i] = kexp(sf2, s[u], e2f);
  };
  // Part g of the copy of chunk c's bands from the other blocks: its
  // 16-byte pieces g * DNT + tid (of 1,024 a band), into registers, then
  // into the copy buffer c % 2.
  uint32_t src[NR];
  auto copy_load = [&](double (&v)[NR][2], int g) {
    const int e = g * DNT + tid, r = e / (BW / 2), col = 2 * (e % (BW / 2));
#pragma unroll
    for (int s = 0; s < NR; ++s)
      if (cr[s] >= 0) ld_cluster(src[s] + (uint32_t)((r * LDB + col) * sizeof(double)), v[s]);
  };
  auto copy_store = [&](const double (&v)[NR][2], int c, int g) {
    const int e = g * DNT + tid, r = e / (BW / 2), col = 2 * (e % (BW / 2));
#pragma unroll
    for (int s = 0; s < NR; ++s)
      if (cr[s] >= 0)
        *reinterpret_cast<double2*>(cps + ((c % 2) * NR + s) * CR * LDB + r * LDB + col) =
            make_double2(v[s][0], v[s][1]);
  };
  auto band = [&](int slot, int c) -> const double* {
    return slot == 0 ? own + (c % 3) * CR * LDB
                     : cps + ((c % 2) * NR + slot - 1) * CR * LDB;
  };

  double acc[16][4], gacc[2] = {0.0, 0.0}, cacc[2] = {0.0, 0.0};
#pragma unroll
  for (int s = 0; s < 16; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = 0.0;
  // Part g of chunk c's product: rows 8 g .. 8 g + 7 of the warp's task,
  // its diagonal 8 x 8 block (group `warp` of the band) and C's rows of it.
  auto product = [&](int c, int g) {
    const double* wb = ws + (c % XS) * CR;
    const double* yb = ys + (c % XS) * CR * DC;
    const double* ob = own + (c % 3) * CR * LDB;
    const double* as = band(a_slot, c);
    const double* bs = band(b_slot, c) + b_col;
    if (kind == 1) rect_step(acc, as, bs, g, wb, gid, tig);
    else if (kind == 2) stair_step(acc, ob, g, wb, gid, tig);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * g + kk, r = 4 * ks + tig;
      const double wr = wb[r];
      const double kv = ob[r * LDB + 8 * warp + gid];
      dmma8(gacc, kv * wr, kv);
      if (staged_y) dmma8(cacc, kv * wr, gid < d ? yb[r * d + gid] : 0.0);
    }
  };

  bool first_fold = true;
  double* pd = part_d + ((size_t)slice * n_tasks + out_task) * BW * BW;
  double* pk = part_comp + ((size_t)slice * n_tasks + out_task) * BW * BW;
  double* pg = part_g + ((size_t)slice * nb * 8 + rank * 8 + warp) * 64;
  double* pgk = part_gcomp + ((size_t)slice * nb * 8 + rank * 8 + warp) * 64;
  // Kahan: running partial += acc; acc = 0.  Each entry has one owner.
  auto kahan = [&](double* tot, double* comp, size_t o, double& v) {
    double tv = v, cv = 0.0;
    if (!first_fold) {
      const double t0 = tot[o], yv = v - comp[o];
      tv = t0 + yv;
      cv = (tv - t0) - yv;
    }
    tot[o] = tv;
    comp[o] = cv;
    v = 0.0;
  };
  auto fold = [&]() {
    if (kind != 0)
#pragma unroll
      for (int s = 0; s < 16; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (kind == 1 ? 16 * (s / 4) : 16 * stair_i(s)) + gid + 8 * (e >> 1);
          const int j = (kind == 1 ? out_col + 8 * (s % 4) : 8 * stair_j(s))
                        + 2 * tig + (e & 1);
          kahan(pd, pk, (size_t)i * BW + j, acc[s][e]);
        }
#pragma unroll
    for (int e = 0; e < 2; ++e) kahan(pg, pgk, gid * 8 + 2 * tig + e, gacc[e]);
    first_fold = false;
  };

  double wsum = 0.0;  // rank 0, warp 0: lane r sums row r's w of every chunk
  // After chunk c's product: C on the CUDA cores when d > DC, its w, the
  // Kahan fold every FOLD_CHUNKS chunks.
  auto finish = [&](int c) {
    const double* wb = ws + (c % XS) * CR;
    if (!staged_y) {
      const double* ob = own + (c % 3) * CR * LDB;
      const long r0 = lo + (long)c * CR;
      const int nr = (int)min((long)CR, hi - r0);
      for (int e = tid; e < BW * d; e += DNT) {
        const int i = e / d, cc = e % d;
        double s = 0.0;
        for (int r = 0; r < nr; ++r)
          s = fma(ob[r * LDB + i] * wb[r], y[(r0 + r) * d + cc], s);
        pc[e] += s;
      }
    }
    if (rank == 0 && tid < CR) wsum += wb[tid];
    if ((c + 1) % FOLD_CHUNKS == 0 || c + 1 == n_chunks) fold();
  };

  issue(0);
  issue(1);
  issue(2);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // z, 1/ell^2, the exp table, chunks 0-2's rows
  for (int c = 0; c < 2 && c < n_chunks; ++c) {
    build(c, 0);
    build(c, 1);
  }
  cluster_arrive();
  cluster_wait();   // every block's chunks 0 and 1 are built
  if (n_chunks > 0) {
#pragma unroll
    for (int s = 0; s < NR; ++s) src[s] = cr[s] >= 0 ? map_rank(own, cr[s]) : 0u;
    for (int g = 0; g < GRP; ++g) {
      double v[NR][2];
      copy_load(v, g);
      copy_store(v, 0, g);
    }
  }
  __syncthreads();  // chunk 0's copies are in
  cluster_arrive();

  // Chunk c: the product of chunk c, the copy of chunk c + 1's bands (after
  // the cluster's wait: every block built c + 1 in chunk c - 1) and the
  // build of chunk c + 2's own band (its buffer held chunk c - 1, which
  // the others copied before the wait of chunk c - 1), in GRP parts; the
  // cluster's wait comes after the first part's product.
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + 3);
    const bool more = c + 1 < n_chunks, next2 = c + 2 < n_chunks;
    if (more)
#pragma unroll
      for (int s = 0; s < NR; ++s)
        src[s] = cr[s] >= 0 ? map_rank(own + ((c + 1) % 3) * CR * LDB, cr[s]) : 0u;
#pragma unroll 1
    for (int g = 0; g < GRP; ++g) {
      double v[NR][2];
      if (more && g > 0) copy_load(v, g);
      product(c, g);
      if (g == 0) {
        cluster_wait();  // the others' chunk c + 1 is built; chunk c is copied
        if (more) copy_load(v, 0);
      }
      if (next2 && (g & 1)) build(c + 2, g >> 1);
      if (more) copy_store(v, c + 1, g);
    }
    finish(c);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // chunk c + 1's copies and c + 3's rows are in
    cluster_arrive();  // built c + 2, copied c + 1
  }
  cluster_wait();  // no block leaves while another may read its band
  if (n_chunks == 0) fold();  // an empty slice writes zeros

  if (staged_y)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (2 * tig + e < d)
        pc[(size_t)(8 * warp + gid) * d + 2 * tig + e] = cacc[e];
  if (rank == 0 && warp == 0) {  // the lanes' sums in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
    if (lane == 0) part_b[slice] = sf2 * wsum;
  }
}

// Fixed-order f64 sums of the cluster kernel's partials: D's entry (a, b),
// a <= b, from its diagonal 8 x 8 block, its band's staircase or its
// pair's region; D's lower half mirrors the upper, so D is exactly
// symmetric.
__global__ void reg_stats_cluster_reduce(const double* __restrict__ part_d,
                                         const double* __restrict__ part_g,
                                         const double* __restrict__ part_c,
                                         const double* __restrict__ part_b,
                                         int n_slices, int nb, int m, int d,
                                         double* __restrict__ D, double* __restrict__ C,
                                         double* __restrict__ b) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (long)m * m) {
    const int r = e / m, c = e % m;
    const int lo = min(r, c), hi = max(r, c);
    const double* src;
    size_t stride, off;
    if (lo / 8 == hi / 8) {
      src = part_g;
      stride = (size_t)nb * 8 * 64;
      off = (size_t)(lo / 8) * 64 + (lo % 8) * 8 + hi % 8;
    } else {
      const int bl = lo / BW, bh = hi / BW;
      const int task = bl == bh ? bl : nb + bl * nb - bl * (bl + 1) / 2 + (bh - bl - 1);
      src = part_d;
      stride = (size_t)nb * (nb + 1) / 2 * BW * BW;
      off = (size_t)task * BW * BW + (lo % BW) * BW + hi % BW;
    }
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += src[sl * stride + off];
    D[e] = s;
  }
  if (e < (long)m * d) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_c[(size_t)sl * nb * BW * d + e];
    C[e] = s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int sl = 0; sl < n_slices; ++sl) s += part_b[sl];
    *b = s;
  }
}

using ClusterFn = decltype(&reg_stats_cluster<8>);

// The variant's kernel for q features (8 and 16 features unrolled, zero
// past q; past 16, x and z from device memory), its shared-memory
// attribute set once per device: a runtime call per launch costs host time
// the card waits for.
cudaError_t prepare_cluster(int q, ClusterFn* kernel) {
  const int v = q > QC ? 0 : q > 8 ? 2 : 1;
  *kernel = v == 0 ? reg_stats_cluster<0> : v == 1 ? reg_stats_cluster<8>
                                                   : reg_stats_cluster<QC>;
  static bool ready[64][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][v]) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)CLUSTER_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][v] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int clusters, int nb, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * nb));
  cfg.blockDim = dim3(DNT);
  cfg.dynamicSmemBytes = CLUSTER_SMEM_BYTES;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_cluster(const double* x, const double* y, const double* w,
                   const double* z, const double* hp, int n, int m, int q, int d,
                   int n_slices, int rows_per_slice, const int* plan,
                   double* part_d, double* part_comp, double* part_g,
                   double* part_gcomp, double* part_c, double* part_b, double* D,
                   double* C, double* b, void* stream) {
  const int nb = (m + BW - 1) / BW;
  if (nb < 1 || nb > NBMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ClusterFn kernel;
  cudaError_t err = prepare_cluster(q, &kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(n_slices, nb, s, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, x, y, w, z, hp, n, m, q, d, nb,
                           rows_per_slice, plan, part_d, part_comp, part_g,
                           part_gcomp, part_c, part_b);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * m > (long)m * d ? (long)m * m : (long)m * d;
  if (total < 1) total = 1;
  reg_stats_cluster_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_d, part_g, part_c, part_b, n_slices, nb, m, d, D, C, b);
  return cudaGetLastError();
}

// Clusters of nb blocks of the variant for q the card holds at once.
int max_clusters(int nb, int q, int* out) {
  ClusterFn kernel;
  cudaError_t err = prepare_cluster(q, &kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, nb, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// ---------------------------------------------------------------------------
// f32: FMA micro-tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FT = 128;          // D tile edge
constexpr int FRC = 32;          // rows per chunk
constexpr int FNT = 256;         // 8 warps; an 8 x 8 micro-tile per thread
constexpr int FBG = 8;           // slab rows per build group

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 2^v on the SFU, one instruction (relative error ~2^-22; results below
// 2^-126 flush to 0).
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Four consecutive floats of shared or device memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared memory of one f32 block, whatever q and d: the f64 layout in
// floats, without the slab padding (a warp reads one slab row).
constexpr size_t FMA_SMEM_BYTES =
    sizeof(float) * (2 * 2 * FRC * FT + 2 * QC * FT + 3 * FRC * QC
                     + 3 * FRC * DC + 3 * FRC + QC + FT * DC);
static_assert(FMA_SMEM_BYTES <= 232448, "f32 block over sm_90's 227 KB");

// The f64 kernel's structure with the product on the CUDA cores.  Each
// thread owns an 8 x 8 patch of the 128 x 128 tile: rows rg*4 + {0..3} and
// 64 + rg*4 + {0..3}, columns cg*4 + {0..3} and 64 + cg*4 + {0..3} (a warp:
// 4 row groups by 8 column groups), so per slab row it loads its 8 entries
// of each slab as two float4 (a warp's reads are 64 and 128 contiguous
// bytes, conflict-free) for 64 FMAs.  hp carries -log2(e) / (2 ell^2) in
// place of 1/ell^2, so an entry is sf2 2^(sum_q (x_q - z_q)^2 s_q): q
// FMAs on the direct differences and one ex2.approx.  CHUNKED as in the
// f64 kernel.
template <bool CHUNKED>
__global__ void __launch_bounds__(FNT, 2)
reg_stats_fma(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ w, const float* __restrict__ z,
              const float* __restrict__ hp, int n, int m, int q, int d,
              int rows_per_slice, int nts, float* __restrict__ part_d,
              float* __restrict__ part_comp, float* __restrict__ part_c,
              float* __restrict__ part_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slabs = reinterpret_cast<float*>(smem_raw);  // [2][2][FRC][FT]
  float* zaT = slabs + 4 * FRC * FT;                  // [QC][FT]
  float* zbT = zaT + QC * FT;                         // [QC][FT]
  float* xs = zbT + QC * FT;                          // [3][FRC * QC]
  float* ys = xs + 3 * FRC * QC;                      // [3][FRC * DC]
  float* ws = ys + 3 * FRC * DC;                      // [3][FRC]
  float* sc = ws + 3 * FRC;                           // [QC]  -log2(e)/(2 ell^2)
  float* cacc = sc + QC;                              // [FT][DC]

  const int n_tiles = nts * (nts + 1) / 2;
  const int slice = (int)blockIdx.x / n_tiles, tile = (int)blockIdx.x % n_tiles;
  int a = 0, rem = tile;
  while (rem >= nts - a) {
    rem -= nts - a;
    ++a;
  }
  const int b = a + rem;
  const bool diag = a == b;
  const int a0 = a * FT, b0 = b * FT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = (warp >> 1) * 4 + (lane >> 3);   // row group, 0..15
  const int cg = (warp & 1) * 8 + (lane & 7);     // column group, 0..15
  const float sf2 = hp[0];

  const long lo = (long)slice * rows_per_slice;
  const long hi = min((long)n, lo + rows_per_slice);
  const int n_chunks = hi > lo ? (int)((hi - lo + FRC - 1) / FRC) : 0;
  const bool staged_y = !CHUNKED && d <= DC;
  float* pc = part_c + ((size_t)slice * nts * FT + a0) * d;
  if (diag)
    for (int e = tid; e < FT * d; e += FNT) (staged_y ? cacc : pc)[e] = 0.f;

  auto stage_z = [&](int k0, int kw) {
    for (int e = tid; e < kw; e += FNT) sc[e] = hp[1 + k0 + e];
    for (int e = tid; e < kw * FT; e += FNT) {
      const int k = e / FT, i = e % FT;
      zaT[e] = a0 + i < m ? z[(size_t)(a0 + i) * q + k0 + k] : 0.f;
      zbT[e] = b0 + i < m ? z[(size_t)(b0 + i) * q + k0 + k] : 0.f;
    }
  };
  auto issue = [&](int c) {
    if (c >= n_chunks) return;
    const long r0 = lo + (long)c * FRC;
    const int bf = c % 3;
    const long xlim = (hi - r0) * q, ylim = (hi - r0) * d;
    for (int e = tid; e < FRC * q; e += FNT)
      cp_async4(xs + bf * FRC * QC + e, e < xlim ? x + r0 * q + e : x,
                e < xlim);
    if (staged_y)
      for (int e = tid; e < FRC * d; e += FNT)
        cp_async4(ys + bf * FRC * DC + e, e < ylim ? y + r0 * d + e : y,
                  e < ylim);
    for (int e = tid; e < FRC; e += FNT)
      cp_async4(ws + bf * FRC + e, r0 + e < hi ? w + r0 + e : w, r0 + e < hi);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Rows [g*FBG, g*FBG + FBG) of the slabs, as the f64 kernel's build.
  auto build = [&](float* aw, float* bs, const float* xb, int xld,
                   const float* wb, int g, int kw, bool first, bool last) {
    const int i = tid % FT, r0 = g * FBG + (tid / FT) * (FBG / 2);
    float sa[FBG / 2], sb[FBG / 2];
#pragma unroll
    for (int u = 0; u < FBG / 2; ++u) {
      sa[u] = first ? 0.f : aw[(r0 + u) * FT + i];
      sb[u] = first || diag ? 0.f : bs[(r0 + u) * FT + i];
    }
    for (int k = 0; k < kw; ++k) {
      const float za = zaT[k * FT + i], zb = zbT[k * FT + i], s = sc[k];
#pragma unroll
      for (int u = 0; u < FBG / 2; ++u) {
        const float xv = xb[(r0 + u) * xld + k];
        const float da = xv - za;
        sa[u] = fmaf(da * da, s, sa[u]);
        if (!diag) {
          const float db = xv - zb;
          sb[u] = fmaf(db * db, s, sb[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FBG / 2; ++u) {
      const int r = r0 + u;
      if (last) {
        const float ka = sf2 * ex2_approx(sa[u]);
        aw[r * FT + i] = wb[r] * ka;
        bs[r * FT + i] = diag ? ka : sf2 * ex2_approx(sb[u]);
      } else {
        aw[r * FT + i] = sa[u];
        if (!diag) bs[r * FT + i] = sb[u];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // Rows [g*FBG, g*FBG + FBG) of a chunk's product acc += aw^T bs.
  auto product = [&](const float* aw, const float* bs, int g) {
#pragma unroll
    for (int r = g * FBG; r < (g + 1) * FBG; ++r) {
      float av[8], bv[8];
      load4(aw + r * FT + rg * 4, av);
      load4(aw + r * FT + 64 + rg * 4, av + 4);
      load4(bs + r * FT + cg * 4, bv);
      load4(bs + r * FT + 64 + cg * 4, bv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  bool first_fold = true;
  float* pd = part_d + (size_t)blockIdx.x * FT * FT;
  float* pk = part_comp + (size_t)blockIdx.x * FT * FT;
  // Kahan: running tile += acc; acc = 0.  Each entry has one owner thread.
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t o = (size_t)((i >> 2) * 64 + rg * 4 + (i & 3)) * FT
                         + h * 64 + cg * 4;
        float tv[4], comp[4] = {0.f, 0.f, 0.f, 0.f};
        if (first_fold) {
#pragma unroll
          for (int j = 0; j < 4; ++j) tv[j] = acc[i][h * 4 + j];
        } else {
          float tot[4], ck[4];
          load4(pd + o, tot);
          load4(pk + o, ck);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float yv = acc[i][h * 4 + j] - ck[j];
            tv[j] = tot[j] + yv;
            comp[j] = (tv[j] - tot[j]) - yv;
          }
        }
        store4(pd + o, tv);
        store4(pk + o, comp);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][h * 4 + j] = 0.f;
      }
    first_fold = false;
  };

  float wsum = 0.f;
  // After chunk c's product: its C rows (diagonal tile) and its sum of w,
  // then the Kahan fold every FOLD_CHUNKS chunks.
  auto finish = [&](int c, const float* aw, const float* wb) {
    if (diag && staged_y) {
      const float* yb = ys + (c % 3) * FRC * DC;
      for (int e = tid; e < FT * d; e += FNT) {
        const int i = e / d, cc = e % d;
        float s = 0.f;
        for (int r = 0; r < FRC; ++r) s = fmaf(aw[r * FT + i], yb[r * d + cc], s);
        cacc[e] += s;
      }
    } else if (diag) {
      const long r0 = lo + (long)c * FRC;
      const int nr = (int)min((long)FRC, hi - r0);
      for (int e = tid; e < FT * d; e += FNT) {
        const int i = e / d, cc = e % d;
        float s = 0.f;
        for (int r = 0; r < nr; ++r) s = fmaf(aw[r * FT + i], y[(r0 + r) * d + cc], s);
        pc[e] += s;
      }
    }
    if (tile == 0 && tid == 0) {
      float s = 0.f;
      for (int r = 0; r < FRC; ++r) s += wb[r];
      wsum += s;
    }
    if ((c + 1) % FOLD_CHUNKS == 0 || c + 1 == n_chunks) fold();
  };

  if constexpr (!CHUNKED) {
    stage_z(0, q);
    issue(0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // z, the scales, chunk 0's rows
    issue(1);
    if (n_chunks > 0)
      for (int g = 0; g < FRC / FBG; ++g)
        build(slabs, slabs + FRC * FT, xs, q, ws, g, q, true, true);

    for (int c = 0; c < n_chunks; ++c) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // chunk c's slabs and chunk c+1's rows are in; c-1 is done
      issue(c + 2);

      // This chunk's product interleaved with the next chunk's slab build
      // (the other slab buffer).
      const float* aw = slabs + (c & 1) * 2 * FRC * FT;
      float* nxt = slabs + ((c + 1) & 1) * 2 * FRC * FT;
      const int nb = (c + 1) % 3;
#pragma unroll
      for (int g = 0; g < FRC / FBG; ++g) {
        product(aw, aw + FRC * FT, g);
        if (c + 1 < n_chunks)
          build(nxt, nxt + FRC * FT, xs + nb * FRC * QC, q, ws + nb * FRC,
                g, q, true, true);
      }
      finish(c, aw, ws + (c % 3) * FRC);
    }
  } else {
    float* aw = slabs;
    float* bs = slabs + FRC * FT;
    for (int c = 0; c < n_chunks; ++c) {
      const long r0 = lo + (long)c * FRC;
      for (int k0 = 0; k0 < q; k0 += QC) {
        const int kw = min(QC, q - k0);
        __syncthreads();  // the staged features and the slabs are free
        stage_z(k0, kw);
        for (int e = tid; e < FRC * kw; e += FNT) {
          const int r = e / kw, k = e % kw;
          xs[r * QC + k] = r0 + r < hi ? x[(r0 + r) * q + k0 + k] : 0.f;
        }
        if (k0 == 0)
          for (int e = tid; e < FRC; e += FNT)
            ws[e] = r0 + e < hi ? w[r0 + e] : 0.f;
        __syncthreads();
        for (int g = 0; g < FRC / FBG; ++g)
          build(aw, bs, xs, QC, ws, g, kw, k0 == 0, k0 + QC >= q);
      }
      __syncthreads();  // the chunk's slabs are complete
#pragma unroll
      for (int g = 0; g < FRC / FBG; ++g) product(aw, bs, g);
      finish(c, aw, ws);
    }
  }
  if (n_chunks == 0) fold();  // an empty slice writes zeros

  if (diag && staged_y)
    for (int e = tid; e < FT * d; e += FNT) pc[e] = cacc[e];
  if (tile == 0 && tid == 0) part_b[slice] = sf2 * wsum;
}

int launch_f32(const float* x, const float* y, const float* w,
               const float* z, const float* hp, int n, int m, int q, int d,
               int n_slices, int rows_per_slice, float* part_d,
               float* part_comp, float* part_c, float* part_b, double* D,
               double* C, double* b, void* stream) {
  const int nts = (m + FT - 1) / FT;
  const long n_tiles = (long)nts * (nts + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool chunked = q > QC;
  auto kernel = chunked ? reg_stats_fma<true> : reg_stats_fma<false>;
  // The shared-memory attribute once per device and variant: a runtime
  // call per launch costs host time the card waits for.
  static bool ready[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][chunked]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)FMA_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][chunked] = true;
  }
  kernel<<<(unsigned)(n_tiles * n_slices), FNT, FMA_SMEM_BYTES, s>>>(
      x, y, w, z, hp, n, m, q, d, rows_per_slice, nts, part_d, part_comp,
      part_c, part_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long total = (long)m * m > (long)m * d ? (long)m * m : (long)m * d;
  if (total < 1) total = 1;
  reg_stats_reduce<float, FT><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part_d, part_c, part_b, n_slices, nts, m, d, D, C, b);
  return cudaGetLastError();
}

}  // namespace

// x (n,q), y (n,d), w (n,), z (m,q), hp = [sf2, -log2(e) / (2 ell^2) (q)]:
// contiguous, f32.  Scratch in f32: part_d and part_comp (n_slices, T, 128,
// 128), part_c (n_slices, nts*128, d), part_b (n_slices,) with nts =
// ceil(m/128) and T = nts(nts+1)/2, one block per (slice, tile).  Outputs
// D (m,m), C (m,d), b (): f64.  Any m, q and d: shared memory is
// FMA_SMEM_BYTES.  Returns cudaGetLastError().
extern "C" int reg_stats_f32(const float* x, const float* y, const float* w,
                             const float* z, const float* hp, int n, int m,
                             int q, int d, int n_slices, int rows_per_slice,
                             float* part_d, float* part_comp, float* part_c,
                             float* part_b, double* D, double* C, double* b,
                             void* stream) {
  return launch_f32(x, y, w, z, hp, n, m, q, d, n_slices, rows_per_slice,
                    part_d, part_comp, part_c, part_b, D, C, b, stream);
}

// f64: hp = [sf2, 1/ell^2 (q)] and the same scratch, in f64.  Any q and
// d: shared memory is DMMA_SMEM_BYTES.
extern "C" int reg_stats_f64(const double* x, const double* y, const double* w,
                             const double* z, const double* hp, int n, int m,
                             int q, int d, int n_slices, int rows_per_slice,
                             double* part_d, double* part_comp,
                             double* part_c, double* part_b, double* D,
                             double* C, double* b, void* stream) {
  return launch_f64(x, y, w, z, hp, n, m, q, d, n_slices, rows_per_slice,
                    part_d, part_comp, part_c, part_b, D, C, b, stream);
}

// f64 at m <= 512: clusters of nb = ceil(m/64) blocks, one a slice of
// rows_per_slice rows (n_slices clusters); plan (nb, PLAN) int32 from
// kernels/reg_stats/kernel.py::cluster_plan.  hp = [sf2, 1/ell^2 (q)].
// Scratch (f64): part_d and part_comp (n_slices, nb (nb + 1) / 2, 64, 64),
// part_g and part_gcomp (n_slices, nb * 8, 8, 8), part_c (n_slices, nb *
// 64, d), part_b (n_slices,).  Outputs as reg_stats_f64.  Any q and d:
// shared memory is CLUSTER_SMEM_BYTES.
extern "C" int reg_stats_f64_cluster(const double* x, const double* y,
                                     const double* w, const double* z,
                                     const double* hp, int n, int m, int q,
                                     int d, int n_slices, int rows_per_slice,
                                     const int* plan, double* part_d,
                                     double* part_comp, double* part_g,
                                     double* part_gcomp, double* part_c,
                                     double* part_b, double* D, double* C,
                                     double* b, void* stream) {
  return launch_cluster(x, y, w, z, hp, n, m, q, d, n_slices, rows_per_slice,
                        plan, part_d, part_comp, part_g, part_gcomp, part_c,
                        part_b, D, C, b, stream);
}

// The clusters of nb blocks (for q features) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int reg_stats_f64_clusters(int nb, int q, int* out) {
  return max_clusters(nb, q, out);
}
