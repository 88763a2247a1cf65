// Causal GQA flash-attention forward for Hopper (sm_90a) on bf16 inputs:
// wgmma on the tensor cores, fed by TMA.
//
// Replaces the reference package's Pallas TPU kernel
//   K5  src/repro/kernels/flash_attention.py::_kernel  (launched by
//       flash_attention_pallas, wrapped by kernels/ops.py::flash_attention)
// for bf16 q, k and v with more than the wrapper's S_SHORT queries (fewer
// go to csrc/flash_attention_short.cu); float32 inputs keep the CUDA-core
// kernel of
// csrc/flash_attention.cu (a TF32 product would not hold the float32 bounds
// that path is checked against: 2e-5 over the kernel sweep, 1e-4 of max
// |logit| over a full float32 prefill).
//
// Function (as csrc/flash_attention.cu): o[b, s, h] = softmax_t(q[b, s, h]
// . k[b, t, h // G] * scale, masked) @ v[b, t, h // G], scale = 1/sqrt(dh),
// q and k dh wide, v and o dv wide (dv <= dh);
// with `causal` key t is visible to query s iff t <= s (top-left); masked
// scores are -1e30; the output is acc / max(l, 1e-30) in bf16.  Scores, m,
// l and the accumulator are float32.  P = exp(s - m) is rounded to bf16
// before P V, as every tensor-core flash attention does, while l sums the
// unrounded float32 p: the output then differs from the plain version (P
// in float32) by at most 2^-8 * max |v| per element (bf16's unit
// roundoff: it keeps 8 significant bits) before its own bf16 rounding.
//
// Instances (DK, DV): the q/k width and the v/o width the kernel is
// compiled for, chosen per call from (dh, dv):
//   (64, 64)    dh <= 64;
//   (96, 64)    64 < dh <= 96 with dv <= 64: MLA's head (minicpm3-4b: 64
//               nope + 32 rope columns over a v of 64);
//   (128, 128)  every other dh <= 128 (e.g. 100, or 96 over a v wider
//               than 64).
// Each instance reads v at its own width dv, zero past dv, and writes o dv
// wide: no instance takes a padded copy of v.
//
// Design.  Grid = (query tiles of kBQ = 128 rows, H, B), query tiles
// heaviest first (reversed blockIdx.x); 384 threads in three warpgroups:
//   * warpgroup 0, the producer (setmaxnreg down to 40 registers), loads Q
//     once and then each kv tile's K and V (kBK = 128 rows) into a ring
//     of kStages stages (4, 3 at DK = 128), each with a full and an
//     empty mbarrier.  Query head h reads kv head h // G through the
//     coordinates it loads, never a copy.  Every tile lands in shared
//     memory with the 128-byte swizzle, 64 bf16 columns per box (Q and K
//     take DK / 64 boxes rounded up, V DV / 64), zero past dh (dv for V)
//     and past S or T;
//   * warpgroups 1 and 2, the consumers (setmaxnreg up to 232), own 64
//     query rows each (the wgmma M).  Per kv tile:
//       S = Q K^T   wgmma m64n{kBK}k16 in DK / 16 k-steps (6 at DK = 96:
//                   the zero columns 96-127 of the second box are never
//                   read), both operands K-major in shared memory (q and k
//                   are dh-contiguous);
//       softmax     on the accumulator fragment in registers: row max and
//                   sum over the four threads of a quad by shuffles, exp2
//                   with scale * log2 e folded into one multiply, m and l
//                   in float32; the -1e30 mask only on tiles that cross the
//                   diagonal or the end of T;
//       O += P V    wgmma m64n{DV}k16: P converted to bf16 in registers is
//                   wgmma's register A operand (the S accumulator's layout
//                   is the A fragment's layout); V is read from shared
//                   memory with the B transpose bit (it is dv-contiguous,
//                   MN-major);
//     then one lane of each warp releases the stage.  With `causal` the kv
//     walk stops at the block's last visible tile, and a warpgroup skips
//     the products of a tile wholly above its own rows.  The epilogue
//     writes the dv columns of O / max(l, 1e-30) through the output
//     strides.
// A consumer thread holds kBK / 2 score, DV / 2 output and kBK / 4 packed P
// registers: 64, 32 and 32 at (64, 64) and (96, 64) alike, 64, 64 and 32
// at (128, 128).
// Two producers, chosen per call (template flag kTMA):
//   * TMA (cp.async.bulk.tensor, 4-D maps over (width, rows, heads,
//     batch), the width dh for q and k, dv for v) where the tensor maps can
//     be encoded: 16-byte aligned bases and every stride a multiple of 16
//     bytes (dh and dv multiples of 8, e.g. 64, 96 and 128).  The box is 64
//     columns wide whatever the width is; columns past it and rows past S
//     or T are filled with zeros by the copy engine, and count in the
//     bytes the stage's barrier expects;
//   * element loads by the producer's 128 threads into the same swizzled
//     layout otherwise (dh = 100 has a 200-byte row stride, which TMA
//     cannot take), each thread fencing its stores for the async proxy
//     before it arrives on the stage's barrier.
// The tensor-map encoder, cuTensorMapEncodeTiled, belongs to the driver
// API and is reached through cudaGetDriverEntryPoint, so the library needs
// no -lcuda; the maps go to the kernel as __grid_constant__ parameters.
//
// What bounds it on this card.  2 (dh + dv) FLOP per visible (query, key)
// pair and head, about 1,600 FLOP per byte of q, k, v and o at S = 4096, so
// the bf16 tensor-core rate (989 TFLOP/s) bounds it (69.5 us for one
// llama3.2-1b layer at S = T = 4096, 108.6 us for one minicpm3-4b layer,
// 139.0 us for one phi3.5-moe layer).  Each consumer runs a tile's two
// products and its softmax in sequence (wgmma waits before the softmax),
// so a warpgroup's softmax overlaps only the other warpgroup's products.
// At (128, 128) kv tiles of 128 (from 64) halve the tiles, their softmaxes
// and barriers, and widen the score product to n128: 13 % faster on the
// H100.  Two orders of the consumers by named barriers (FlashAttention-3's
// ping-pong: their Q K^T in turns, or each turn also carrying the previous
// tile's P V) measured slower than no order at all, and are not used.
//
// C interface (bound with ctypes): flash_attention_sm90_fwd(...) launches on
// the given stream, does not synchronise, reports the producer and the
// instance it chose and returns cudaGetLastError().  The host sets each
// instantiation's shared-memory limit once per device.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;       // query rows per block, 64 per consumer
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;

template <int DK, int DV>
struct Cfg {
  static constexpr int kKBoxes = (DK + 63) / 64;      // 64-column boxes: Q, K
  static constexpr int kVBoxes = (DV + 63) / 64;      // V
  static constexpr int kBK = 128;                     // kv rows per tile
  static constexpr int kStages = DK == 128 ? 3 : 4;   // ring depth
  static constexpr int kQBytes = kBQ * kKBoxes * 128;
  static constexpr int kKBytes = kBK * kKBoxes * 128;  // one K tile
  static constexpr int kVBytes = kBK * kVBoxes * 128;  // one V tile
  // + 1024 to align the swizzled tiles; above half the SM's shared memory,
  // so one block per SM (the register split of setmaxnreg assumes it);
  // (96, 64): 32 KB of Q + 4 x (32 + 16) KB of K and V + 1 KB = 230,400;
  // (128, 128): 32 KB of Q + 3 x (32 + 32) KB + 1 KB = 230,400
  static constexpr int kSmem =
      kQBytes + kStages * (kKBytes + kVBytes) + 1024;
  static_assert(DK % 16 == 0 && DV % 8 == 0 && DV <= DK, "instance");
  static_assert(kSmem + 8 * (2 * kStages + 1) <= kSmemMax, "shared memory");
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, G, dh, dv, causal;
  int o_pairs;       // o can be written as aligned bf16 pairs
  float scale_log2;  // scale * log2 e
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of the given parity has completed.  A stage that
// never completes (about 10 s of clock) traps, so a fault fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Element loads of `rows` rows (from row r0 of src, rows >= L and columns
// >= width as zeros) into COLS / 64 boxes of rows x 64 columns with the
// 128-byte swizzle, as TMA would place them: the 16-byte chunk c / 8 of row
// r goes to chunk (c / 8) ^ (r % 8).  The producer runs in 40 registers:
// unrolled by the compiler's choice, the (96, 64) instance's two widths of
// tile spilled 20 bytes there; unrolled by 2 no instance spills.
template <int COLS>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int rows,
                                          int L, int width, int t) {
#pragma unroll 2
  for (int idx = t; idx < rows * COLS; idx += 128) {
    const int r = idx / COLS, d = idx % COLS;
    __nv_bfloat16 x = __ushort_as_bfloat16(0);
    if (r0 + r < L && d < width) x = src[(long long)(r0 + r) * ss + d];
    const int c = d & 63;
    *reinterpret_cast<__nv_bfloat16*>(dst + (d >> 6) * rows * 128 + r * 128 +
                                      (((c >> 3) ^ (r & 7)) << 4) +
                                      (c & 7) * 2) = x;
  }
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K): 8-row groups 1024 bytes apart (SBO); a k16 step moves the start
// 32 bytes along the row.  The MN-major V: 8 kv rows 1024 bytes apart
// (SBO), the next 64 columns one box further (LBO).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// wgmma m64nNk16, bf16 inputs, float32 accumulators: A and B from shared
// memory (ss: both K-major) or A from registers (rs: B transposed).

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a0, a1, a2, a3, db);
  else wgmma_rs_n128(d, a0, a1, a2, a3, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- kernel

template <int DK, int DV, bool kTMA>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using C = Cfg<DK, DV>;
  constexpr int kBK = C::kBK, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::kQBytes;            // kStages K tiles
  uint8_t* sV = sK + kStages * C::kKBytes;  // kStages V tiles
  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[kStages]);
  const uint32_t qbar = smem_u32(&bars[2 * kStages]);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  int n_kv = (p.T + kBK - 1) / kBK;
  if (p.causal) n_kv = min(n_kv, (min(q0 + kBQ, p.S) - 1) / kBK + 1);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kTMA ? 1 : 128);
      mbar_init(empty0 + 8 * s, 8);  // one lane of each consumer warp
    }
    mbar_init(qbar, kTMA ? 1 : 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if constexpr (kTMA) {
      if (tid == 0) {
        // every box lands whole (its zero fill included): the barriers
        // expect the bytes of the boxes issued
        mbar_expect_tx(qbar, C::kQBytes);
        for (int bx = 0; bx < C::kKBoxes; ++bx)
          tma_load_4d(smem_u32(sQ + bx * kBQ * 128), &tq, qbar, bx * 64, q0,
                      h, b);
        for (int kt = 0; kt < n_kv; ++kt) {
          const int s = kt % kStages;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
          mbar_expect_tx(full, C::kKBytes + C::kVBytes);
          for (int bx = 0; bx < C::kKBoxes; ++bx)
            tma_load_4d(smem_u32(sK + s * C::kKBytes + bx * kBK * 128), &tk,
                        full, bx * 64, kt * kBK, hk, b);
          for (int bx = 0; bx < C::kVBoxes; ++bx)
            tma_load_4d(smem_u32(sV + s * C::kVBytes + bx * kBK * 128), &tv,
                        full, bx * 64, kt * kBK, hk, b);
        }
      }
    } else {
      const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
      const __nv_bfloat16* k = p.k + b * p.k_sb + hk * p.k_sh;
      const __nv_bfloat16* v = p.v + b * p.v_sb + hk * p.v_sh;
      constexpr int kQK = C::kKBoxes * 64, kV = C::kVBoxes * 64;
      load_tile<kQK>(sQ, q, p.q_ss, q0, kBQ, p.S, p.dh, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(qbar);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        load_tile<kQK>(sK + s * C::kKBytes, k, p.k_ss, kt * kBK, kBK, p.T,
                       p.dh, tid);
        load_tile<kV>(sV + s * C::kVBytes, v, p.v_ss, kt * kBK, kBK, p.T,
                      p.dv, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wc = wg - 1;
    const int ct = tid & 127, warp = ct >> 5, lane = ct & 31;
    const int row_min = q0 + 64 * wc;
    const int row_max = min(row_min + 63, p.S - 1);
    // accumulator fragment: d[4j + e] is row r_lo + 8 (e / 2), column
    // 8 j + cq + e % 2 of the warpgroup's 64 x N tile
    const int r_lo = row_min + 16 * warp + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const bool live = row_min < p.S;
    const float sl2 = p.scale_log2;
    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const uint32_t q_addr = smem_u32(sQ) + wc * 64 * 128;

    mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kv; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      const int k0 = kt * kBK;
      if (live && !(p.causal && k0 > row_max)) {
        const uint32_t k_addr = smem_u32(sK + s * C::kKBytes);
        const uint32_t v_addr = smem_u32(sV + s * C::kVBytes);

        // S = Q K^T over the DK columns: k-step ks reads 16 columns of box
        // ks / 4, 32 bytes along its rows
        float sc[kBK / 2];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < DK / 16; ++ks) {
          const uint32_t col = (ks & 3) * 32;
          mma_ss<kBK>(sc,
                      make_desc(q_addr + (ks >> 2) * kBQ * 128 + col, 16,
                                1024),
                      make_desc(k_addr + (ks >> 2) * kBK * 128 + col, 16,
                                1024),
                      ks > 0);
        }
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        // mask only where the tile crosses the diagonal or the end of T
        if (k0 + kBK > p.T || (p.causal && k0 + kBK - 1 > row_min)) {
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * j + cq + (e & 1);
              const int row = r_lo + 8 * (e >> 1);
              if (col >= p.T || (p.causal && col > row))
                sc[4 * j + e] = kNegInf;
            }
        }

        // online softmax on the fragment; l sums the unrounded p
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - mn0) * sl2), a1 = ex2((m1 - mn1) * sl2);
        m0 = mn0;
        m1 = mn1;
        const float b0 = mn0 * sl2, b1 = mn1 * sl2;
        uint32_t pr[kBK / 4];
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float p00 = ex2(fmaf(sc[4 * j], sl2, -b0));
          const float p01 = ex2(fmaf(sc[4 * j + 1], sl2, -b0));
          const float p10 = ex2(fmaf(sc[4 * j + 2], sl2, -b1));
          const float p11 = ex2(fmaf(sc[4 * j + 3], sl2, -b1));
          ls0 += p00 + p01;
          ls1 += p10 + p11;
          pr[2 * j] = pack_bf16(p00, p01);
          pr[2 * j + 1] = pack_bf16(p10, p11);
        }
        l0 = l0 * a0 + ls0;
        l1 = l1 * a1 + ls1;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }

        // O += P V: P (bf16) from registers, V MN-major from shared memory
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          mma_rs<DV>(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2],
                     pr[4 * kk + 3],
                     make_desc(v_addr + kk * 16 * 128, kBK * 128, 1024));
        wg_commit();
        wg_wait0();
        fence_regs(o);
        fence_regs(pr);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    if (!live) return;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float den[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r_lo + 8 * e;
      if (row >= p.S) continue;
      __nv_bfloat16* orow = ob + row * p.o_ss;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int d = 8 * j + cq;
        const float x0 = o[4 * j + 2 * e] / den[e];
        const float x1 = o[4 * j + 2 * e + 1] / den[e];
        if (p.o_pairs && d + 1 < p.dv) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < p.dv) orow[d] = __float2bfloat16(x0);
          if (d + 1 < p.dv) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
    else
      cudaGetLastError();  // the query's failure is not the launch's
  }
  return fn;
}

// A 4-D map over (width, rows, heads, batch) with a 64 x box_rows box and
// the 128-byte swizzle; false where TMA cannot take the tensor.
bool encode(CUtensorMap* map, const void* base, int width, int L, int Hn,
            int B, long long ss, long long sh, long long sb, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || width % 8 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const long long st[3] = {ss, sh, sb};
  const int ext[3] = {L, Hn, B};
  cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)L, (cuuint64_t)Hn,
                        (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    long long bytes = st[i] * 2;
    if (ext[i] == 1)  // never stepped: any valid stride will do
      bytes = bytes < 16 ? 16 : (bytes + 15) / 16 * 16;
    if (bytes <= 0 || bytes % 16 != 0 || bytes >= (1ll << 40)) return false;
    strides[i] = (cuuint64_t)bytes;
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV, bool kTMA>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B, int H,
                   cudaStream_t stream) {
  auto kern = flash_fwd_sm90_kernel<DK, DV, kTMA>;
  constexpr int smem = Cfg<DK, DV>::kSmem;
  // the shared-memory limit is set once per instantiation and device, not
  // on every launch
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// chosen = {producer (1 TMA, 0 element loads), DK, DV}
template <int DK, int DV>
cudaError_t launch_instance(const Params& p, int B, int H, int Hk,
                            int* chosen, cudaStream_t stream) {
  constexpr int kBK = Cfg<DK, DV>::kBK;
  CUtensorMap tq{}, tk{}, tv{};
  const bool tma =
      encode(&tq, p.q, p.dh, p.S, H, B, p.q_ss, p.q_sh, p.q_sb, kBQ) &&
      encode(&tk, p.k, p.dh, p.T, Hk, B, p.k_ss, p.k_sh, p.k_sb, kBK) &&
      encode(&tv, p.v, p.dv, p.T, Hk, B, p.v_ss, p.v_sh, p.v_sb, kBK);
  chosen[0] = tma ? 1 : 0;
  chosen[1] = DK;
  chosen[2] = DV;
  return tma ? launch<DK, DV, true>(tq, tk, tv, p, B, H, stream)
             : launch<DK, DV, false>(tq, tk, tv, p, B, H, stream);
}

}  // namespace

extern "C" {

// bf16 q, k (dh wide), v and o (dv wide); strides in elements.  chosen[0]
// is set to 1 where the tiles went in by TMA, 0 where by element loads;
// chosen[1] and chosen[2] to the instance's (DK, DV).
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long o_sb, long long o_ss,
                             long long o_sh, int B, int S, int T, int H,
                             int Hk, int dh, int dv, float scale, int causal,
                             int* chosen, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      dh <= 0 || dh > 128 || dv <= 0 || dv > dh || B > 65535 ||
      H > 65535 || chosen == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.S = S;
  p.T = T;
  p.G = H / Hk;
  p.dh = dh;
  p.dv = dv;
  p.causal = causal ? 1 : 0;
  p.o_pairs = reinterpret_cast<uintptr_t>(o) % 4 == 0 && dv % 2 == 0 &&
              o_sb % 2 == 0 && o_ss % 2 == 0 && o_sh % 2 == 0;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return (int)launch_instance<64, 64>(p, B, H, Hk, chosen, st);
  if (dh <= 96 && dv <= 64)
    return (int)launch_instance<96, 64>(p, B, H, Hk, chosen, st);
  return (int)launch_instance<128, 128>(p, B, H, Hk, chosen, st);
}

const char* flash_attention_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
