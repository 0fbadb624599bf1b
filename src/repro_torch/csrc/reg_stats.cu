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
// exp per (row, column) it is built for.  Shared by both instantiations:
//   * The TPU carries the D/C/b accumulators from one step of a sequential
//     n-grid to the next.  Here blocks run in parallel and in no order, so
//     each block owns one unit (n-slice, upper D tile): one tile (a, b)
//     with a <= b and one slice of rows; it stages RC rows at a time and
//     builds the slabs ka*w and kb of its tile's columns in shared memory.
//     Only the upper tiles are computed; the lower half is their mirror.
//     The units go on gridDim.x (unit = slice * tiles + tile, which also
//     indexes the unit's partial), so no m is refused: gridDim.y stopped at
//     65,535 tiles.
//   * C is accumulated on the diagonal tiles (a == b), b on tile 0, in the
//     same pass.  On a diagonal tile kb is ka, so its slab is built once.
//   * A second small kernel sums the per-slice partials in a fixed order
//     (slice 0, 1, ...) in f64 and mirrors D: no atomics, so results are
//     deterministic, and splitting n keeps the error of a 1e6-row sum
//     small.  Within a slice, partial sums are folded into the running tile
//     with Kahan compensation.
//   * The exponent is evaluated directly as sum_q (x_q - z_q)^2 * inv_q
//     (q FMAs per entry).  The Pallas kernel's expanded form alpha + M.Zc is
//     not anchored and cancels in f32 for inputs with large offsets; the
//     direct form has no such cancellation and costs little at q = 8.
//   * Ragged edges are masked, never padded into the result: rows past n
//     (or past the slice) carry w = 0 and x = y = 0; inducing points past m
//     carry z = 0 and are never written out; q and d are loop bounds.  No
//     result depends on the tile size.
//
// f64 (what the f64 models call): D on the FP64 tensor cores.
//   * 128 x 128 upper tiles (10 at m = 512), and as many n-slices as fill
//     the 132 SMs once (13 at m = 512: 130 blocks, one per SM), so each
//     (row, column) entry of the slab is built m/128 = 4 times over the
//     grid instead of m/64 = 8 times with 64 x 64 tiles.  The slab build
//     (q DFMAs and one libdevice exp per entry, on the CUDA cores) is then
//     as large as the D product itself, and the two overlap: a chunk's
//     product runs beside the next chunk's build, the slabs double
//     buffered in shared memory.
//   * The product is mma.sync m16n8k4 f64 (DMMA, IEEE f64 on the tensor
//     cores): 8 warps, each a 64 x 32 part of the tile as 4 x 4 fragments
//     in registers.  The fragments accumulate over 4,096 rows, then are
//     folded into the running tile with Kahan compensation; running tile
//     and compensation live in the block's own scratch in device memory
//     (L2), each entry touched by one thread only.
//   * The next chunk's x and w are in flight (cp.async, three buffers)
//     while the current one is built and multiplied: one barrier a chunk.
//   * Shared memory is fixed (DMMA_SMEM_BYTES), whatever q and d: z, x and
//     1/ell^2 are staged QC = 16 features at a time (one chunk for every
//     config of the repo; past that the exponent sums accumulate in the
//     slab buffers over the chunks, without the overlap above), and y and
//     C's rows are staged DC = 8 columns wide; past that C accumulates in
//     the diagonal block's own rows of part_c, with y read from device
//     memory.
//
// f32 (the TPU kernel's f32 contract): the same structure with the product
// in IEEE f32 on the CUDA cores (TF32 misses the f32 tier), so the product
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
//   * The f64 kernel's overlap (double-buffered slabs, cp.async rows in
//     three buffers, one barrier a chunk) and its Kahan fold every 4,096
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
