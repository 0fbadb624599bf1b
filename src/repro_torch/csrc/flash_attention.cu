// Flash attention (online softmax) for LM prefill on Hopper (sm_90a):
//
//     o[b, h, r] = sum_c softmax_c(scale * q[b, h, r] . k[b, h/group, c]) v[b, h/group, c]
//
// over the keys c that row r sees: c < S and, when causal, c <= r + (S - T)
// (queries suffix-aligned to the keys).  A row that sees no key returns 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:80,
// flash_attention (body _fa_kernel, pallas_call at :106).
//
// What bounds it on the H100: operations.  Each visible (query, key) pair
// costs 2*Dh multiply-adds and one exp against 4*Dh bytes of q, k, v and o
// per row; at the llama3.2-1b prefill (B 4, H 32, Hkv 8, T = S = 2048,
// Dh 64) that is 6.9e10 flops over 84 MB.  Two designs, one per input type:
//
// bf16 (the main path): both products on the tensor cores.
//   * One block per (b, h, 128-row query tile): three warpgroups.  Warpgroup
//     0 is the producer: one thread issues TMA loads, Q once per block, K and
//     V 128-key tiles into a 3-stage ring in shared memory, each stage
//     guarded by a "full" mbarrier (TMA bytes landed) and an "empty" one
//     (both consumers done with it).  It gives up registers (setmaxnreg 24);
//     warpgroups 1 and 2 take them (240), each owning 64 query rows.
//   * S = Q K^T is wgmma m64n128k16 (bf16 in, f32 out) from shared memory,
//     both operands K-major under the 128-byte swizzle that TMA writes.  S
//     stays in the accumulator registers; the online softmax runs on that
//     fragment layout (row max by shuffles within a quad of threads, the row
//     sum kept per thread and summed across the quad once at the end).
//   * P is rounded to bf16 in registers and is the register A operand of the
//     PV wgmma (m64nDhk16, V read N-major from shared memory): no trip
//     through shared memory.  SDPA rounds P to bf16 likewise; the Pallas
//     kernel keeps it in f32 (PERF.md records the error this costs).
//   * Per consumer, tile i's QK^T is issued, then the rescale of O and tile
//     i-1's PV; tile i's softmax runs while that PV is on the tensor cores.
//     The register operands of a wgmma are written only when no wgmma is
//     pending that reads them, so ptxas does not serialise the wgmmas.
//   * The tensor maps describe the strided (B, H, T, Dh) views the model
//     passes; TMA fills rows past T or S with zeros, so nothing is padded.
//     They are built on the host at each call (cuTensorMapEncodeTiled, got
//     through cudaGetDriverEntryPoint, so no driver library is linked).
//     TMA needs 16-byte aligned bases and strides; the wrapper checks that.
//   * Dh 128 is loaded as two 64-column boxes (a 128-byte swizzle row holds
//     64 bf16); the wgmma descriptors step across them.
//   What bounds it now is the softmax on the CUDA cores and the SFU: one
//   ex2 per pair (taken flush-to-zero, a single SFU op) and ~5 f32 ops
//   beside it, issued by only 8 consumer warps per SM.  FA3's ping-pong of
//   the two consumers (one's softmax under the other's wgmmas) is not done
//   yet.
//
// f32 (f32 compute): every multiply-add in IEEE f32 on the CUDA cores (no
//   tensor cores, no TF32).  Its floor is the f32 FMA rate (128 lanes an
//   SM a clock), and beside it shared memory, which delivers 128 bytes an
//   SM a clock: an R x C register tile of a product whose operands both
//   come from shared memory takes 4 (1/R + 1/C) bytes per FMA, exactly 1
//   at 8 x 8, so the FMA pipes and the shared-memory path saturate
//   together there (on the A100, with half the FMA lanes, 8 x 8 left
//   shared memory half idle).  A larger tile does not fit the registers
//   beside the output accumulator.
//   * The query heads of one kv group share a block (hb of them, the
//     largest power of two up to 8 dividing the group; 128 rows in all),
//     so each K/V tile is loaded once for all of them, not once per head.
//   * K and V tiles (64 keys at Dh 64, 32 at Dh 128) are loaded by cp.async,
//     each in one buffer, staggered: K of tile i + 1 while tile i's P V
//     runs, V of tile i while its scores and softmax run.  q, k and v keep
//     their natural row layout (a thread reads 4 features of a row as one
//     16-byte load), rows padded by 4 floats so the loads of a quarter-warp
//     fall on distinct banks.  Views whose bases or strides are not 16-byte
//     aligned are copied 4 bytes at a time instead.  At Dh 64 a block needs
//     111,616 bytes, so two 128-thread blocks share an SM and one's
//     barriers overlap the other's work (a 256-row block with a two-stage
//     ring measured the same).
//   * Each thread owns 8 rows x 8 keys of the score tile (8 x 4 at Dh 128)
//     and the same 8 rows x 8 columns of the output (x 16 at Dh 128): 16
//     FMAs per 16-byte load in both products, 1 byte per FMA.  Rows are
//     interleaved (ty + TY i) and keys too (tx + TX j), so a quarter-warp's
//     loads are conflict-free.  4 rows a thread with twice the threads
//     (more warps to hide latency) measured slower: 1.5 bytes per FMA.
//   * The softmax: the row max by shuffles across the 8 threads of a row,
//     the row sum per thread, summed once at the end.  Each thread keeps
//     its running max and sum in shared memory rather than registers
//     (read once a tile; the products use the registers), and P goes
//     through shared memory (transposed, each thread's rows contiguous)
//     between the two products: two barriers per key tile.
//
// Rules both designs keep:
//   * The TPU walks a sequential kv grid axis and carries the running max,
//     normaliser and accumulator in VMEM scratch.  Here a block loops over
//     the key tiles itself, the three running quantities on chip (the
//     accumulator in registers).  The kv head is h / group, so grouped K/V
//     is read in place.
//   * Masked scores are -inf, not a large negative number: a tile in which
//     a row sees nothing leaves that row's max at -inf, its exps are taken
//     against 0 and come out exactly 0, and the row's sum stays 0, so a row
//     with no visible key writes exactly 0 whatever the tiling.  (The Pallas
//     kernel's -1e30 makes such rows depend on its block size.)  The mask is
//     applied only on tiles that cross the diagonal or the ragged S edge.
//   * Key tiles entirely above the diagonal are never loaded.  Query tiles
//     are issued last-first, so the longest rows of a causal launch start
//     first.
//   * Exps are exp2 (the SFU's ex2, flush-to-zero: one instruction) of
//     scores times scale * log2(e) minus the row max.  Scores, softmax and
//     sums are f32; o is in q's type.
//
// Instantiations: Dh 64 and 128 for each type.  C interface, bound with
// ctypes from src/repro_torch/kernels/flash_attention/kernel.py.
#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, t;  // elements; the last axis is contiguous
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;      // query rows per block (two consumers x 64)
constexpr int TC_BK = 128;      // keys per kv tile
constexpr int TC_STAGES = 3;    // K/V ring depth
constexpr int TC_NT = 384;      // producer warpgroup + two consumer warpgroups
constexpr int SW_ROW = 128;     // bytes per swizzled row: 64 bf16
constexpr int SW_ATOM = 1024;   // 8 swizzled rows

template <int DH>
struct TcLayout {
  static constexpr int NH = DH / 64;                  // 64-column boxes
  static constexpr int Q_HALF = TC_BQ * SW_ROW;       // one box of Q
  static constexpr int KV_HALF = TC_BK * SW_ROW;      // one box of K or V
  static constexpr int Q_BYTES = NH * Q_HALF;
  static constexpr int KV_BYTES = NH * KV_HALF;       // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + TC_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * KV_BYTES;
  // full[STAGES], empty[STAGES], q; plus slack to align the base to 1024
  static constexpr int SMEM = BAR_OFF + 8 * (2 * TC_STAGES + 1) + SW_ATOM;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// One box of a 4-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (between 64-column boxes of an N-major operand; unused for a
// K-major one) and stride byte offset (between groups of 8 rows), all >> 4.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads of a wgmma accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128) += A (64 x 16, shared) B (128 x 16, shared, K-major); d = A B when !accumulate
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, N-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// 2^x on the SFU (MUFU.EX2), subnormal results flushed to 0: a probability
// below 2^-126 is lost against the row's largest, which is 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of a 64 x N f32 wgmma accumulator: thread (warp w, lane
// l) of the warpgroup holds rows w*16 + l/4 (registers 4j, 4j+1) and
// w*16 + l/4 + 8 (4j+2, 4j+3), at columns 8j + 2(l%4) + {0, 1}.
template <int DH>
__global__ void __launch_bounds__(TC_NT, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, int group, int t, int s_len,
             int causal, float scale_log2) {
  using L = TcLayout<DH>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + SW_ATOM - 1) & ~uint32_t(SW_ATOM - 1);
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t full = base + L::BAR_OFF;            // full[s] = full + 8s
  const uint32_t empty = full + 8 * TC_STAGES;        // empty[s] = empty + 8s
  const uint32_t qbar = empty + 8 * TC_STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int hi = blockIdx.y, bi = blockIdx.z, kh = hi / group;
  const int q_offset = s_len - t;
  // Keys [0, kv_end) hold every key a row of this tile sees.
  int kv_end = s_len;
  if (causal) kv_end = min(s_len, max(0, min(q0 + TC_BQ, t) + q_offset));
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int hb = 0; hb < L::NH; ++hb)
        tma_load(q_s + hb * L::Q_HALF, &qmap, qbar, hb * 64, q0, hi, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % TC_STAGES, round = i / TC_STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * L::KV_BYTES);
        for (int hb = 0; hb < L::NH; ++hb) {
          tma_load(k_s + s * L::KV_BYTES + hb * L::KV_HALF, &kmap, full + 8 * s,
                   hb * 64, i * TC_BK, kh, bi);
          tma_load(v_s + s * L::KV_BYTES + hb * L::KV_HALF, &vmap, full + 8 * s,
                   hb * 64, i * TC_BK, kh, bi);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1, lt = tid % 128, warp = lt / 32, lane = lt % 32;
    const int r0 = q0 + c * 64;                       // first row of this consumer
    const int row_a = r0 + warp * 16 + lane / 4;      // and row_a + 8
    const int col_t = 2 * (lane % 4);

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    const uint32_t q_rows = q_s + c * 64 * SW_ROW;

    float sc[64];                 // scores of one tile, then its probabilities
    uint32_t pf[TC_BK / 16][4];   // P in bf16: the PV wgmma's A fragments
    float corr[2];                // rescale of acc before the next PV

    // S_i = Q K_i^T into sc: Dh/16 steps of k16 (32 bytes along a row)
    auto issue_s = [&](int i) {
      const int s = i % TC_STAGES;
      mbar_wait(full + 8 * s, (i / TC_STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::Q_HALF + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * L::KV_HALF + (kk % 4) * 32;
        wgmma_ss_n128(sc, gmma_desc(q_rows + off, 16, SW_ATOM),
                      gmma_desc(k_s + s * L::KV_BYTES + koff, 16, SW_ATOM), kk > 0);
      }
      wgmma_commit();
    };
    // acc = corr * acc + P_i V_i: V N-major, 16 keys per step
    auto issue_pv = [&](int i) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= corr[r];
          acc[4 * j + 2 * r + 1] *= corr[r];
        }
      const int s = i % TC_STAGES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        wgmma_pv<DH>(acc, pf[kk], gmma_desc(v_s + s * L::KV_BYTES + kk * 16 * SW_ROW,
                                            L::KV_HALF, SW_ATOM));
      wgmma_commit();
    };
    // online softmax over tile i's scores in sc, in the log2 domain: sc
    // becomes P, corr the factor for the running output
    auto softmax = [&](int i) {
      const int k0 = i * TC_BK;
      const bool masked = k0 + TC_BK > s_len ||
                          (causal && k0 + TC_BK - 1 > r0 + q_offset);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * j + 2 * r + e];
            if (masked) {
              const int col = k0 + 8 * j + col_t + e;
              if (col >= s_len || (causal && col > row + q_offset)) v = -INFINITY;
            }
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[r], mx * scale_log2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = ex2(m_i[r] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = sc[4 * j + 2 * r + e];
            v = ex2(fmaf(v, scale_log2, -m_use));
            rs += v;
          }
        l_i[r] = l_i[r] * corr[r] + rs;   // this thread's share of the row sum
        m_i[r] = m_new;
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    // Tile i's QK^T runs beside the rescale and tile i-1's PV is queued
    // behind it; tile i's softmax then runs while that PV is in flight.
    if (n_tiles > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0);
      pack();
    }
    for (int i = 1; i < n_tiles; ++i) {
      issue_s(i);
      issue_pv(i - 1);
      wgmma_wait<1>();                  // S_i is in
      fence_regs(sc);
      softmax(i);
      wgmma_wait<0>();                  // PV_{i-1} is in: P and V_{i-1} free
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % TC_STAGES));
      pack();
    }
    if (n_tiles > 0) {
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    __nv_bfloat16* ob = o + ((long long)bi * gridDim.y + hi) * t * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row_a + 8 * r;
      if (row >= t) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * DH + 8 * j + col_t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a (B, H, L, Dh) bf16 view, strides in elements (Dh
// contiguous): boxes of 64 columns x `rows` rows of one (b, h), 128-byte
// swizzle, zeros past L.
bool make_map(CUtensorMap* map, const void* ptr, int b, int h, int len, int dh,
              long long sb, long long sh, long long st, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)len, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int h, int hkv, int t, int s_len, Strides qs, Strides ks,
              Strides vs, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, b, h, t, DH, qs.b, qs.h, qs.t, TC_BQ) ||
      !make_map(&km, k, b, hkv, s_len, DH, ks.b, ks.h, ks.t, TC_BK) ||
      !make_map(&vm, v, b, hkv, s_len, DH, vs.b, vs.h, vs.t, TC_BK))
    return cudaErrorInvalidValue;
  constexpr int smem = TcLayout<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + TC_BQ - 1) / TC_BQ, h, b);
  fa_tc_kernel<DH><<<grid, TC_NT, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), h / hkv, t, s_len, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

// Block shapes per head dim: TY x TX threads, each owning RPT = 8 query
// rows (ty + TY i) x BK/TX keys (tx + TX j) of the score tile and the same
// 8 rows x DH/TX columns (tx*4 + 4 TX c + e) of the output.
template <int DH> struct F32Cfg;
template <> struct F32Cfg<64> {
  static constexpr int TY = 16, TX = 8, BK = 64;   // 128 rows, 8 x 8 scores
};
template <> struct F32Cfg<128> {
  static constexpr int TY = 16, TX = 8, BK = 32;   // 128 rows, 8 x 4 scores
};

template <int DH>
struct F32Layout {
  using C = F32Cfg<DH>;
  static constexpr int TY = C::TY, TX = C::TX, BK = C::BK, RPT = 8;
  static constexpr int NT = TX * TY;      // threads
  static constexpr int BR = RPT * TY;     // query rows per block
  static constexpr int KPT = BK / TX;     // keys per thread
  static constexpr int CPT = DH / TX;     // output columns per thread
  static constexpr int LD = DH + 4;       // row stride of the q, k, v tiles
  static constexpr int LDP = BR + 4;      // row stride of the p tile
  static constexpr int Q_OFF = 0;                    // [BR][LD]
  static constexpr int K_OFF = Q_OFF + BR * LD;      // [BK][LD]
  static constexpr int V_OFF = K_OFF + BK * LD;      // [BK][LD]
  static constexpr int P_OFF = V_OFF + BK * LD;      // [BK][LDP]
  static constexpr int M_OFF = P_OFF + BK * LDP;     // [RPT][NT] running max
  static constexpr int L_OFF = M_OFF + RPT * NT;     // [RPT][NT] running sum
  static constexpr size_t SMEM = sizeof(float) * (L_OFF + RPT * NT);
};

// Asynchronous copies into shared memory; a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four floats at src (16-byte aligned when vec) into dst.
__device__ __forceinline__ void cp_row4(float* dst, const float* src, bool ok,
                                        bool vec) {
  if (vec) {
    cp_async16(dst, src, ok);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(F32Layout<DH>::NT)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int h,
              int group, int hb, int t, int s_len, Strides qs, Strides ks,
              Strides vs, int causal, float scale_log2, int vec) {
  using L = F32Layout<DH>;
  constexpr int TY = L::TY, TX = L::TX, BK = L::BK, NT = L::NT, BR = L::BR;
  constexpr int RPT = L::RPT, KPT = L::KPT, CPT = L::CPT, LD = L::LD;
  constexpr int LDP = L::LDP;
  constexpr int D4 = DH / 4;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const qsm = sm + L::Q_OFF;
  float* const psm = sm + L::P_OFF;
  float* const msm = sm + L::M_OFF;
  float* const lsm = sm + L::L_OFF;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int rh = BR / hb;                       // rows of each head
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rh;
  const int h0 = blockIdx.y * hb, bi = blockIdx.z;
  const int q_offset = s_len - t;
  const float* kb = k + bi * ks.b + (h0 / group) * ks.h;
  const float* vb = v + bi * vs.b + (h0 / group) * vs.h;

  // Keys [0, kv_end) hold every key a row of this block sees.
  int kv_end = s_len;
  if (causal) kv_end = min(s_len, max(0, min(q0 + rh, t) + q_offset));
  const int n_kt = (kv_end + BK - 1) / BK;

  float* const kt = sm + L::K_OFF;
  float* const vt = sm + L::V_OFF;
  // K or V (base xb, row stride xt) of keys [k0, k0 + BK) into dst; keys
  // past S are zeros.
  auto load_tile = [&](float* dst, const float* xb, long long xt, int k0) {
    for (int c = tid; c < BK * D4; c += NT) {
      const int j = c / D4, d = (c % D4) * 4;
      const bool ok = k0 + j < s_len;
      cp_row4(dst + j * LD + d, xb + (ok ? k0 + j : 0) * xt + d, ok, vec);
    }
  };

  if (n_kt > 0) {
    // Q once (row r: head h0 + r / rh, query q0 + r % rh), then K of tile 0.
    for (int c = tid; c < BR * D4; c += NT) {
      const int r = c / D4, d = (c % D4) * 4;
      const int qr = q0 + r % rh;
      const bool ok = qr < t;
      const float* src = q + bi * qs.b + (long long)(h0 + r / rh) * qs.h
                         + (long long)(ok ? qr : 0) * qs.t + d;
      cp_row4(qsm + r * LD + d, src, ok, vec);
    }
    load_tile(kt, kb, ks.t, 0);
    cp_async_commit();
  }

  // The softmax state lives in shared memory, each thread's own, so the
  // products keep the registers.
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    msm[i * NT + tid] = -INFINITY;
    lsm[i * NT + tid] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // K of tile it loads during the products of tile it - 1, V of tile it
  // during the scores of tile it: two barriers a tile.
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BK;
    cp_async_wait_all();
    __syncthreads();  // K of tile it landed; tile it-1's products are done
    load_tile(vt, vb, vs.t, k0);
    cp_async_commit();

    // s = q k^T: per 4 features, RPT + KPT 16-byte loads for 4 RPT KPT FMAs
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qf[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qsm + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(kt + (tx + TX * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          s[i][j] = fmaf(qf[i].x, kf.x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf.y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf.z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf.w, s[i][j]);
        }
      }
    }

    // online softmax over this tile's keys, in the log2 domain; the row max
    // across the TX threads of a row by shuffles, the row sum per thread
    const bool masked = k0 + BK > s_len || (causal && k0 + BK - 1 > q0 + q_offset);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
      if (masked) {
        const int last = q0 + (ty + TY * i) % rh + q_offset;  // row's last key
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int col = k0 + tx + TX * j;
          if (col >= s_len || (causal && col > last)) s[i][j] = -INFINITY;
        }
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = msm[i * NT + tid];
      const float m_new = fmaxf(m_old, mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m_old - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = ex2(fmaf(s[i][j], scale_log2, -m_use));
        rs += s[i][j];
      }
      lsm[i * NT + tid] = fmaf(lsm[i * NT + tid], corr, rs);
      msm[i * NT + tid] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    // p, transposed: p[key][ty * RPT + i], a thread's rows contiguous
#pragma unroll
    for (int j = 0; j < KPT; ++j)
#pragma unroll
      for (int i = 0; i < RPT; i += 4)
        *reinterpret_cast<float4*>(psm + (tx + TX * j) * LDP + ty * RPT + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    cp_async_wait_all();
    __syncthreads();  // V landed, every row's p is written, K is free
    if (it + 1 < n_kt) {
      load_tile(kt, kb, ks.t, k0 + BK);
      cp_async_commit();
    }

    // acc += p v: per key, (RPT + CPT) / 4 16-byte loads for RPT CPT FMAs
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; i += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(psm + j * LDP + ty * RPT + i);
        pv[i] = p4.x;
        pv[i + 1] = p4.y;
        pv[i + 2] = p4.z;
        pv[i + 3] = p4.w;
      }
#pragma unroll
      for (int c = 0; c < CPT / 4; ++c) {
        const float4 vf = *reinterpret_cast<const float4*>(vt + j * LD + tx * 4 + 4 * TX * c);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][4 * c + 0] = fmaf(pv[i], vf.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pv[i], vf.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pv[i], vf.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pv[i], vf.w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float l = lsm[i * NT + tid];
#pragma unroll
    for (int off = 1; off < TX; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = ty + TY * i, qr = q0 + r % rh;
    if (qr >= t) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = o + (((long long)bi * h + h0 + r / rh) * t + qr) * DH;
#pragma unroll
    for (int c = 0; c < CPT / 4; ++c)
      *reinterpret_cast<float4*>(orow + tx * 4 + 4 * TX * c) =
          make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                      acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
  }
}

bool aligned16(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.h % 4 == 0 && st.t % 4 == 0;
}

template <int DH>
int launch_f32(const float* q, const float* k, const float* v, float* o, int b,
               int h, int hkv, int t, int s_len, Strides qs, Strides ks,
               Strides vs, int causal, float scale, cudaStream_t stream) {
  using L = F32Layout<DH>;
  // The shared-memory attribute once per device: a runtime call per launch
  // costs host time the card waits for.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(fa_f32_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  // hb query heads of one kv group share a block (the largest power of two
  // up to 8 dividing the group), each with BR / hb query rows.
  const int group = h / hkv;
  int hb = 1;
  while (hb < 8 && group % (2 * hb) == 0) hb *= 2;
  const int rh = L::BR / hb;
  const int vec = aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs);
  const dim3 grid((t + rh - 1) / rh, h / hb, b);
  fa_f32_kernel<DH><<<grid, L::NT, L::SMEM, stream>>>(
      q, k, v, o, h, group, hb, t, s_len, qs, ks, vs, causal,
      scale * 1.4426950408889634f, vec);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,T,Dh), k/v (B,Hkv,S,Dh), given by their element strides over B, H
// and T (Dh contiguous); o (B,H,T,Dh) contiguous, in the inputs' type.
// H % Hkv == 0, Dh in {64, 128}.  The bf16 entry also needs 16-byte
// aligned bases and strides (TMA); a size-1 axis may carry any stride that
// is.  Returns cudaGetLastError(), or cudaErrorInvalidValue when a tensor
// map cannot be encoded.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int t, int s_len, int dh, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int causal, float scale, void* stream) {
  if (b == 0 || h == 0 || t == 0) return cudaSuccess;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_tc<64>(q, k, v, o, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  if (dh == 128)
    return launch_tc<128>(q, k, v, o, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int t, int s_len, int dh, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int causal, float scale, void* stream) {
  if (b == 0 || h == 0 || t == 0) return cudaSuccess;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const float*>(q), kp = static_cast<const float*>(k),
       vp = static_cast<const float*>(v);
  auto op = static_cast<float*>(o);
  if (dh == 64)
    return launch_f32<64>(qp, kp, vp, op, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  if (dh == 128)
    return launch_f32<128>(qp, kp, vp, op, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  return cudaErrorInvalidValue;
}
