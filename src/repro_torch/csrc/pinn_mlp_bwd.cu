// PINN-MLP fused reverse sweep for Hopper (sm_90a), CUDA C++ on the CUDA
// cores.
//
// Replaces the reference package's Pallas TPU kernel
//   K4  src/repro/kernels/pinn_mlp.py::_kernel2_bwd (the hand-derived
//       reverse sweep of the second-order tangent recurrence)
// and computes what it and the plain version ref._ref2_bwd compute: from
// the spills of the training forward (pinn_mlp_fwd.cu with SAVE: h, t_j and
// the kept s_k entering every activation stage) and the cotangents
// (u-bar, du-bar, d2u-bar) it gives x-bar per point and the W-bar, b-bar
// and a-bar stacks summed over all points of each subdomain.  Template
// parameters: activation (0 tanh, 1 sin, 2 cos), d_in (1-3) and NS, the
// number of kept second-order streams (the entries of d2_dirs); pruned d2u
// rows are never read, so their cotangents cannot reach the inputs.
//
// Cotangent rules (p_k = phi^(k)(a h), as at pinn_mlp.py:243-258):
//   through affine layer l+1:  W-bar += g^T h-bar + sum_j t~_j^T t-bar_j
//                                       + sum_k s~_k^T s-bar_k,
//                              b-bar += sum_n h-bar, then every cotangent
//                              stream times W^T (g-bar, t~-bar, s~-bar);
//   through activation l:      e1 = p2 h a + p1, e2 = p3 h a^2 + 2 p2 a,
//     a-bar_l += g-bar p1 h + t~-bar_j t_j e1 + s~-bar_k (t_k^2 e2 + s_k e1)
//     h-bar    = g-bar p1 a + t~-bar_j t_j p2 a^2
//                + s~-bar_k (t_k^2 p3 a^3 + s_k p2 a^2)
//     t-bar_j  = t~-bar_j p1 a (+ s~-bar_k 2 p2 a^2 t_j where d2_dirs[k] = j)
//     s-bar_k  = s~-bar_k p1 a
//   input layer:  x-bar = h-bar_0 W_0^T,
//                 W-bar_0 = x^T h-bar_0 + row_j sum_n t-bar_0,j,
//                 b-bar_0 = sum_n h-bar_0.
// The activation factors are recomputed from the spilled h; no matrix
// product of the forward is recomputed.
//
// What bounds it on this card.  It reads the spills the forward wrote
// (1.5 KB per point at width 24 x 4, S = 4) and does twice the forward's
// matrix FLOPs (the W-bar products and the W^T products).  At the
// quickstart's megabatch (n_sub 4 x 1120 rows, 24 x 4) the spill bytes
// bound it at 2.1 us; at 80 x 5 the FP32 FMAs bound it at 27.5 us.  The
// first version reached 4.2 % of either bound (NVIDIA H100 80GB HBM3,
// 700 W): 128 threads and 32-row tiles gave 4 warps per SM (one block per
// SM at width 80, where its 149 KB of shared memory let no second block in,
// and two blocks of each subdomain walked two tiles); each thread owned one
// W-bar column group and ran a 128-step dependent chain over the tile's
// rows, one float4 and one scalar load per 4 FMAs; about five barriers a
// layer plus a seven-barrier tree for a-bar; the spills came by scalar loads
// behind the barrier that ended the previous layer.  The same kernel at 256
// threads and 16-row tiles was 1.3-1.5x faster on the card.  This design
// reaches 9 % and 14 %.  Clock stamps per phase (a probe, not kept) put
// most of a block's time at 80 x 5 in the two products, and the W-bar
// product was the costlier: each stage of a block's later tiles reads back
// and rewrites the block's 25.6 KB partial of W-bar (its read now goes out
// before the products).  At the quickstart's shape the products are about
// half of a block's time; the rest is the stages' elementwise work, their
// barriers and the reduction kernel.
//
// Design.  Grid = (blocks per subdomain, n_sub), 256 threads; three blocks
// resident per SM for four streams (the quickstart's: registers capped at
// 80), two otherwise.  A block owns a contiguous range of row tiles
// (tile_m rows: 12, or 8 or 4 where that leaves room for two blocks per SM)
// of one subdomain; the plan gives every subdomain as many blocks as the
// card holds resident at once (up to one per tile), so no block walks more
// than one tile more than another (at the quickstart's shape every block
// walks one).  Per tile it walks the layers backward; each (tile, layer)
// is a stage.  A stage's inputs, the S spilled streams (each one contiguous
// run of rows x wp floats) and W_{l+1}, arrive by 1-D bulk copies
// (cp.async.bulk, completing on an mbarrier) into one of two stage
// buffers: the next stage's copies are issued when a stage starts, so they
// land while it computes (the first stage's when the block starts, before
// its cotangents are loaded).  The streams of a tile form one stacked
// (S * tile_m) x wp matrix in shared memory.  Per stage:
//   (1) the streams entering affine layer l+1 (g, t~, s~) from the spills;
//   (2) W-bar_{l+1} += G^T Bar, a (wp x S tile_m) (S tile_m x wp) product: a
//       4 x 4 register micro-tile of W-bar per thread fed by two float4 loads
//       per 16 FMAs, the block's partial so far loaded before the products;
//       at small widths the rows are split into ksplit chunks (the tile's
//       rows cut in ksplit ranges, every stream of them), each chunk's
//       partial in its own thread's registers, combined in chunk order in
//       shared memory; b-bar sums h-bar;
//   (3) H = Bar W^T on the stacked streams, one task list with (2) from the
//       next warp on, a 4 x 4 micro-tile per thread (rows strided by a
//       quarter of the stacked height; each thread starts its walk over the
//       columns of W at its own offset, so neighbouring lanes read distinct
//       banks of W's rows);
//   (4) the activation stage: the spills and H give the new Bar and each
//       thread's share of a-bar, summed by a warp shuffle tree and then over
//       the warps in order.
// Three barriers a stage.  Rows past the ragged tail are never read from the
// stage buffers (the copies stop at the tail) and keep cotangents of exact
// zeros, so they add nothing.
//
// Cross-block reduction.  The TPU kernel adds W-bar, b-bar and a-bar into
// one output block over a sequential grid.  Hopper blocks run in no order,
// so each block adds into its own partial slice (n_sub, blocks, E floats;
// no other block touches it, no atomics), and a second kernel here sums the
// partials of each subdomain: eight contiguous groups of blocks, each in
// block order, then the groups in order.  The tile partition, ksplit
// and every summation order depend only on the shapes and the card, so two
// launches on the same inputs give bitwise equal results.
//
// Precision: plain IEEE FP32 (fmaf, tanhf/sinf/cosf, no fast math, no TF32,
// no float atomics).
//
// C interface (bound with ctypes): pinn_mlp_bwd_plan(...) picks the tile and
// the number of blocks per subdomain (the caller sizes the partials with
// them); pinn_mlp_bwd(...) launches the sweep and the reduction on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;           // resident blocks per SM, at least
constexpr int kMaxSplit = 8;            // chunks of the W-bar rows
constexpr size_t kSmemMax = 232448;     // dynamic shared memory per block
constexpr size_t kSmemSM = 233472;      // shared memory per SM
constexpr size_t kSmemReserve = 1024;   // reserved per resident block
constexpr int kBarBytes = 16;           // two mbarriers ahead of the floats

struct Params {
  const float* x;     // (n_sub, n_pts, d_in)
  const float* w;     // (n_sub, n_layers + 1, wp, wp), zero padded
  const float* a;     // (n_sub, n_layers + 1) slopes
  const float* res;   // (n_sub, n_layers, S, n_pts, wp) spills
  const float* cu;    // (n_sub, n_pts, n_out)
  const float* cdu;   // (n_sub, d_in, n_pts, n_out)
  const float* cd2u;  // (n_sub, d_in, n_pts, n_out); unused when NS == 0
  float* cx;          // (n_sub, n_pts, d_in)
  float* part;        // (n_sub, n_blocks, E) per-block partials
  int n_pts, wp, n_layers, n_out, tile_m, n_tiles, n_blocks, ksplit;
  int sel[3];         // s-stream k carries direction sel[k]
};

// floats of one block's partial slice: W-bar, b-bar, a-bar stacks, padded
// to a multiple of 4 so that every slice starts 16-byte aligned
__host__ __device__ inline size_t part_len(int n_layers, int wp) {
  const size_t l1 = (size_t)n_layers + 1;
  return (l1 * wp * wp + l1 * wp + l1 + 3) & ~(size_t)3;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

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

// Wait until the phase of the given parity has completed; a copy that never
// lands (about 10 s of clock) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One 1-D bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// component c (a constant after unrolling) of a float4
__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
// 1 where the kept stream's direction `sel` is j, else 0: the one-hot
// weight by which a t_j is picked without an indexed (local) array
__device__ __forceinline__ float pick(int sel, int j) {
  return sel == j ? 1.f : 0.f;
}

template <int ACT>
__device__ __forceinline__ void act_eval(float z, float& g, float& p1,
                                         float& p2, float& p3) {
  if constexpr (ACT == 0) {
    const float th = tanhf(z);
    const float sech2 = 1.0f - th * th;
    g = th;
    p1 = sech2;
    p2 = -2.0f * th * sech2;
    p3 = (6.0f * th * th - 2.0f) * sech2;
  } else if constexpr (ACT == 1) {
    g = sinf(z);
    p1 = cosf(z);
    p2 = -g;
    p3 = -p1;
  } else {
    g = cosf(z);
    p1 = -sinf(z);
    p2 = -g;
    p3 = -p1;
  }
}

// Add v into a partial slot, or set it on the block's first tile.
__device__ __forceinline__ void put(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}
__device__ __forceinline__ void put4(float* dst, float4 v, bool first) {
  if (!first) {
    const float4 o = ld4(dst);
    v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
  }
  st4(dst, v);
}

// three resident blocks per SM (80 registers a thread) for four streams,
// the quickstart's (d_in 2, one kept second-order stream): there every
// block then walks one tile; two for the other stream counts, whose
// instantiations would spill at 80
template <int ACT, int D_IN, int NS>
__global__ void __launch_bounds__(kThreads, 1 + D_IN + NS == 4 ? 3 : 2)
pinn_mlp_bwd_kernel(const Params p) {
  constexpr int S = 1 + D_IN + NS;  // streams: h, t_0..t_{d_in-1}, s_0..
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = p.wp, tm = p.tile_m, L = p.n_layers, tid = threadIdx.x;
  const int plane = tm * wp, wsz = wp * wp;
  const int stg = S * plane + wsz;  // a stage buffer: spills, then W_{l+1}
  const int ksplit = p.ksplit;
  const uint32_t bar0 = smem_u32(smem_raw);
  float* base = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* G = base + 2 * stg;   // streams entering affine layer l+1
  float* H = G + S * plane;    // the cotangents times W^T
  float* Bar = H + S * plane;  // cotangent streams
  float* scr = Bar + S * plane;                       // ksplit W-bar chunks
  float* red = scr + (ksplit > 1 ? ksplit * wsz : 0);  // a-bar per warp
  float* xs = red + kWarps;    // the tile's x rows, (tile_m, d_in)
  float* w0s = xs + 3 * tm;    // rows 0..d_in-1 of W_0

  const int q = blockIdx.y, blk = blockIdx.x;
  const int tile0 = (int)((long long)blk * p.n_tiles / p.n_blocks);
  const int tile1 = (int)((long long)(blk + 1) * p.n_tiles / p.n_blocks);
  const size_t pstride = (size_t)p.n_pts * wp;  // one spilled stream
  const float* W = p.w + (size_t)q * (L + 1) * wsz;
  const float* A = p.a + (size_t)q * (L + 1);
  const float* X = p.x + (size_t)q * p.n_pts * D_IN;
  float* Pw = p.part + ((size_t)q * p.n_blocks + blk) * part_len(L, wp);
  float* Pb = Pw + (size_t)(L + 1) * wsz;
  float* Pa = Pb + (size_t)(L + 1) * wp;
  const int n_stage = (tile1 - tile0) * L;

  // the copies of stage k (tile tile0 + k / L, layer L - 1 - k % L) into
  // stage buffer k & 1; thread 0 only
  auto issue = [&](int k) {
    const int tile = tile0 + k / L, l = L - 1 - k % L;
    const int row0 = tile * tm, rows = min(tm, p.n_pts - row0);
    const uint32_t bar = bar0 + 8 * (k & 1);
    float* F = base + (k & 1) * stg;
    const uint32_t bytes = (uint32_t)(rows * wp * 4);
    mbar_expect_tx(bar, S * bytes + wsz * 4);
    const float* R = p.res + ((size_t)q * L + l) * S * pstride +
                     (size_t)row0 * wp;
#pragma unroll
    for (int s = 0; s < S; ++s)
      bulk_load(smem_u32(F + s * plane), R + s * pstride, bytes, bar);
    bulk_load(smem_u32(F + S * plane), W + (size_t)(l + 1) * wsz, wsz * 4,
              bar);
  };

  // the tile's x rows and the cotangents of its outputs (padded columns
  // and the ragged tail as 0) into xs and Bar
  auto load_inputs = [&](int tile) {
    const int row0 = tile * tm, rows = min(tm, p.n_pts - row0);
    for (int i = tid; i < rows * D_IN; i += kThreads)
      xs[i] = X[(size_t)row0 * D_IN + i];
    for (int i = tid; i < plane; i += kThreads) {
      const int r = i / wp, c = i - r * wp;
      const bool live = r < rows && c < p.n_out;
      const size_t pt = (size_t)row0 + r;
      Bar[i] = live ? p.cu[((size_t)q * p.n_pts + pt) * p.n_out + c] : 0.f;
#pragma unroll
      for (int j = 0; j < D_IN; ++j) {
        const size_t o = (((size_t)q * D_IN + j) * p.n_pts + pt) * p.n_out + c;
        Bar[(1 + j) * plane + i] = live ? p.cdu[o] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const size_t o =
            (((size_t)q * D_IN + p.sel[kk]) * p.n_pts + pt) * p.n_out + c;
        Bar[(1 + D_IN + kk) * plane + i] = live ? p.cd2u[o] : 0.f;
      }
    }
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_stage > 0) issue(0);
  }
  for (int i = tid; i < D_IN * wp; i += kThreads) w0s[i] = W[i];
  load_inputs(tile0);

  const int nq = wp / 4, n_mt = nq * nq;
  const int n2 = n_mt * ksplit;         // W-bar tasks
  const int n2w = (n2 + 31) & ~31;      // the W^T product's from a new warp
  const int nrg = S * tm / 4;           // row groups of the stacked streams
  const int n23 = n2w + nrg * nq;       // plus the W^T product's tasks
  const int warp = tid >> 5, lane = tid & 31;
  int k = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const int row0 = tile * tm;
    const int rows = min(tm, p.n_pts - row0);
    if (!first) {
      __syncthreads();  // the previous tile is done with Bar
      load_inputs(tile);
    }

    for (int l = L - 1; l >= 0; --l, ++k) {
      const float* F = base + (k & 1) * stg;
      const float* sW = F + S * plane;
      __syncthreads();  // Bar complete; the other stage buffer, G, H free
      if (tid == 0) {
        if (l < L - 1) {  // a-bar of the stage before, from the warps
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += red[w];
          put(Pa + l + 1, s, first);
        }
        if (k + 1 < n_stage) issue(k + 1);
      }
      mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
      // (1) the streams entering affine layer l+1
      const float al = A[l];
      const int live = rows * wp;  // rows past the ragged tail read as 0
      for (int i = tid; i < plane; i += kThreads) {
        float v[S];
#pragma unroll
        for (int s = 0; s < S; ++s) v[s] = i < live ? F[s * plane + i] : 0.f;
        float g, p1, p2, p3;
        act_eval<ACT>(al * v[0], g, p1, p2, p3);
        const float d1 = p1 * al, d2 = p2 * (al * al);
        G[i] = g;
#pragma unroll
        for (int j = 0; j < D_IN; ++j) G[(1 + j) * plane + i] = d1 * v[1 + j];
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          float t = 0.f;  // t_{sel[kk]} by a one-hot blend: exact
#pragma unroll
          for (int j = 0; j < D_IN; ++j)
            t = fmaf(pick(p.sel[kk], j), v[1 + j], t);
          G[(1 + D_IN + kk) * plane + i] = d2 * t * t + d1 * v[1 + D_IN + kk];
        }
      }
      __syncthreads();
      // (2) b-bar_{l+1}, W-bar_{l+1} += G^T Bar and (3) H = Bar W_{l+1}^T
      for (int c = tid; c < wp; c += kThreads) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += Bar[r * wp + c];
        put(Pb + (size_t)(l + 1) * wp + c, acc, first);
      }
      float* Pwl = Pw + (size_t)(l + 1) * wsz;
      for (int task = tid; task < n23; task += kThreads) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
        if (task < n2) {
          // chunk j of the tile's rows, micro-tile (k0.., c0..) of W-bar
          const int j = task / n_mt, mt = task - j * n_mt;
          const int kq = mt / nq, k0 = 4 * kq, c0 = 4 * (mt - kq * nq);
          const int r_lo = j * tm / ksplit;
          const int r_hi = min((j + 1) * tm / ksplit, rows);
          // the block's partial so far, loaded before the products so that
          // its latency hides under them
          float4 prev[4];
          const bool rmw = ksplit == 1 && !first;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            prev[i] = rmw ? ld4(Pwl + (size_t)(k0 + i) * wp + c0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          // row by row, every stream of a row in turn (the sum's order,
          // fixed by the shapes)
          for (int r = r_lo; r < r_hi; ++r) {
#pragma unroll(S > 4 ? 2 : 4)
            for (int s = 0; s < S; ++s) {
              const int off = s * plane + r * wp;
              const float4 g4 = ld4(G + off + k0), b4 = ld4(Bar + off + c0);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float gv = comp(g4, i);
                acc[i][0] = fmaf(gv, b4.x, acc[i][0]);
                acc[i][1] = fmaf(gv, b4.y, acc[i][1]);
                acc[i][2] = fmaf(gv, b4.z, acc[i][2]);
                acc[i][3] = fmaf(gv, b4.w, acc[i][3]);
              }
            }
          }
          float* dst = ksplit > 1 ? scr + (size_t)j * wsz : Pwl;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                         acc[i][3]);
            if (ksplit > 1)
              st4(dst + (k0 + i) * wp + c0, v);
            else
              st4(dst + (size_t)(k0 + i) * wp + c0,
                  rmw ? make_float4(prev[i].x + v.x, prev[i].y + v.y,
                                    prev[i].z + v.z, prev[i].w + v.w)
                      : v);
          }
        } else if (task >= n2w) {
          // rows rg + i * nrg of the stacked streams, columns k0.. of H;
          // the walk over W's columns starts at this task's own offset
          const int t3 = task - n2w, rg = t3 / nq, kq = t3 - rg * nq;
          const int k0 = 4 * kq;
#pragma unroll 1
          for (int cc = 0; cc < wp; cc += 4) {
            int c = cc + k0;
            if (c >= wp) c -= wp;
            float4 b4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              b4[i] = ld4(Bar + (rg + i * nrg) * wp + c);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w4 = ld4(sW + (k0 + kk) * wp + c);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float t = acc[i][kk];
                t = fmaf(b4[i].x, w4.x, t);
                t = fmaf(b4[i].y, w4.y, t);
                t = fmaf(b4[i].z, w4.z, t);
                t = fmaf(b4[i].w, w4.w, t);
                acc[i][kk] = t;
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            st4(H + (rg + i * nrg) * wp + k0,
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        }
      }
      __syncthreads();
      if (ksplit > 1) {  // the chunks of W-bar_{l+1}, in chunk order
        for (int e = 4 * tid; e < wsz; e += 4 * kThreads) {
          float4 s = ld4(scr + e);
          for (int j = 1; j < ksplit; ++j) {
            const float4 v = ld4(scr + (size_t)j * wsz + e);
            s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
          }
          put4(Pwl + e, s, first);
        }
      }
      // (4) activation stage l: F (h, t, s) and H (the pulled-back
      //     cotangents) give the new Bar and this thread's share of a-bar_l
      float ca = 0.f;  // (rows past the tail keep Bar = 0)
      for (int i = tid; i < live; i += kThreads) {
        const float h = F[i];
        float g, p1, p2, p3;
        act_eval<ACT>(al * h, g, p1, p2, p3);
        const float d1 = p1 * al, d2 = p2 * (al * al);
        const float p3a3 = p3 * (al * al * al);
        const float e1 = p2 * h * al + p1;
        const float e2 = p3 * h * (al * al) + 2.0f * p2 * al;
        const float bg = H[i];
        float cai = bg * (p1 * h);
        float nh = bg * d1;
        float nt[D_IN];
#pragma unroll
        for (int j = 0; j < D_IN; ++j) {
          const float bt = H[(1 + j) * plane + i];
          const float t = F[(1 + j) * plane + i];
          cai = fmaf(bt * t, e1, cai);
          nh = fmaf(bt * t, d2, nh);
          nt[j] = bt * d1;
        }
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
          const float bs = H[(1 + D_IN + kk) * plane + i];
          const float s = F[(1 + D_IN + kk) * plane + i];
          const float t = F[(1 + p.sel[kk]) * plane + i];
          cai = fmaf(bs, t * t * e2 + s * e1, cai);
          nh = fmaf(bs, t * t * p3a3 + s * d2, nh);
#pragma unroll
          for (int j = 0; j < D_IN; ++j)  // only nt[sel[kk]] changes
            nt[j] = fmaf(pick(p.sel[kk], j) * (bs * (2.0f * d2)), t, nt[j]);
          Bar[(1 + D_IN + kk) * plane + i] = bs * d1;
        }
        Bar[i] = nh;
#pragma unroll
        for (int j = 0; j < D_IN; ++j) Bar[(1 + j) * plane + i] = nt[j];
        ca += cai;
      }
      // a-bar_l: a fixed shuffle tree in each warp; the warps are summed in
      // order after the next barrier
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ca += __shfl_down_sync(0xffffffffu, ca, o);
      if (lane == 0) red[warp] = ca;
    }

    __syncthreads();
    if (tid == 0 && L > 0) {  // a-bar_0 from the warps
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      put(Pa, s, first);
    }
    // input layer: x-bar = h-bar W_0^T, W-bar_0 = x^T h-bar + row_j sum t-bar
    for (int i = tid; i < rows * D_IN; i += kThreads) {
      const int r = i / D_IN, j = i - r * D_IN;
      float acc = 0.f;
      for (int c = 0; c < wp; ++c)
        acc = fmaf(Bar[r * wp + c], w0s[j * wp + c], acc);
      p.cx[((size_t)q * p.n_pts + row0 + r) * D_IN + j] = acc;
    }
    // b-bar_0 (j = -1) and the rows j < d_in of W-bar_0, an entry a thread
    for (int e = tid; e < (1 + D_IN) * wp; e += kThreads) {
      const int j = e / wp - 1, c = e - (j + 1) * wp;
      if (j < 0) {
        float hb = 0.f;
        for (int r = 0; r < rows; ++r) hb += Bar[r * wp + c];
        put(Pb + c, hb, first);
      } else {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r)
          acc = fmaf(xs[r * D_IN + j], Bar[r * wp + c], acc);
        float tb = 0.f;
        for (int r = 0; r < rows; ++r) tb += Bar[(1 + j) * plane + r * wp + c];
        put(Pw + (size_t)j * wp + c, acc + tb, first);
      }
    }
    if (first) {  // rows of W_0 past d_in, and the unused last slope
      for (int e = D_IN * wp + tid; e < wsz; e += kThreads) Pw[e] = 0.f;
      if (tid == 0) Pa[L] = 0.f;
    }
  }
}

// Sum each subdomain's partials into W-bar, b-bar, a-bar: the blocks are
// cut into kGroups contiguous groups, each summed in block order by its own
// thread (eight loads in flight), and the groups' sums are added in group
// order.  A block of this kernel covers 256 / kGroups entries.
constexpr int kGroups = 8;

__global__ void __launch_bounds__(256)
pinn_mlp_bwd_reduce(const float* part, float* cw, float* cb, float* ca,
                    int n_blocks, int n_layers, int wp) {
  __shared__ float sums[kGroups][256 / kGroups];
  const int q = blockIdx.y, g = threadIdx.x / (256 / kGroups);
  const int el = threadIdx.x - g * (256 / kGroups);
  const size_t e = (size_t)blockIdx.x * (256 / kGroups) + el;
  const size_t len = part_len(n_layers, wp);
  float acc = 0.f;
  if (e < len) {
    const float* P = part + (size_t)q * n_blocks * len + e;
    int b = (int)((long long)g * n_blocks / kGroups);
    const int b1 = (int)((long long)(g + 1) * n_blocks / kGroups);
    for (; b + 8 <= b1; b += 8) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = P[(size_t)(b + i) * len];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += v[i];
    }
    for (; b < b1; ++b) acc += P[(size_t)b * len];
  }
  sums[g][el] = acc;
  __syncthreads();
  if (g != 0 || e >= len) return;
  for (int j = 1; j < kGroups; ++j) acc += sums[j][el];
  const size_t l1 = (size_t)n_layers + 1, nw = l1 * wp * wp, nb = l1 * wp;
  if (e < nw)
    cw[q * nw + e] = acc;
  else if (e < nw + nb)
    cb[q * nb + (e - nw)] = acc;
  else if (e < nw + nb + l1)
    ca[q * l1 + (e - nw - nb)] = acc;
}

// chunks of the W-bar rows: as many as keep the W-bar tasks (rounded up to
// whole warps) and the W^T product's tasks within one round of the block's
// threads (at small widths), at most kMaxSplit and at most one row a chunk
int pick_split(int s, int tm, int wp) {
  const int nq = wp / 4, n_mt = nq * nq, n3 = (s * tm / 4) * nq;
  for (int k = kMaxSplit < tm ? kMaxSplit : tm; k > 1; --k)
    if (((n_mt * k + 31) & ~31) + n3 <= kThreads) return k;
  return 1;
}

size_t smem_bytes(int s, int tm, int wp) {
  const size_t plane = (size_t)tm * wp, wsz = (size_t)wp * wp;
  const int ks = pick_split(s, tm, wp);
  return kBarBytes + (2 * (s * plane + wsz) + 3 * s * plane +
                      (ks > 1 ? ks * wsz : 0) + kWarps + 3 * tm + 3 * wp) *
                         sizeof(float);
}

// tile rows: the largest of 12, 8, 4 that leaves room for kMinBlocks blocks
// per SM, else the largest that fits one block (0 when none fits).  12, not
// 16: at the quickstart's shape 94 tiles a subdomain, fewer than the 99
// blocks three resident a SM give it, so every block walks one tile
// (1.05x faster than 16-row tiles on the card)
int pick_tile(int s, int wp) {
  const int cand[] = {12, 8, 4};
  for (int tm : cand)
    if (kSmemSM / (smem_bytes(s, tm, wp) + kSmemReserve) >= kMinBlocks)
      return tm;
  for (int tm : cand)
    if (smem_bytes(s, tm, wp) <= kSmemMax) return tm;
  return 0;
}

// blocks_per_sm != nullptr: report the occupancy of the instantiation;
// otherwise launch it
template <int ACT, int D_IN, int NS>
cudaError_t plan_or_launch(const Params* p, int n_sub, int* blocks_per_sm,
                           cudaStream_t stream) {
  auto kern = pinn_mlp_bwd_kernel<ACT, D_IN, NS>;
  const int tm = pick_tile(1 + D_IN + NS, p->wp);
  const size_t smem = smem_bytes(1 + D_IN + NS, tm, p->wp);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern,
                                                         kThreads, smem);
  kern<<<dim3(p->n_blocks, n_sub), kThreads, smem, stream>>>(*p);
  return cudaGetLastError();
}

template <int ACT, int D_IN, int NS = 0>
cudaError_t by_ns(int ns, const Params* p, int n_sub, int* bps,
                  cudaStream_t stream) {
  if constexpr (NS > D_IN) {
    return cudaErrorInvalidValue;
  } else {
    if (ns == NS) return plan_or_launch<ACT, D_IN, NS>(p, n_sub, bps, stream);
    return by_ns<ACT, D_IN, NS + 1>(ns, p, n_sub, bps, stream);
  }
}

template <int ACT>
cudaError_t by_d_in(int d_in, int ns, const Params* p, int n_sub, int* bps,
                    cudaStream_t stream) {
  switch (d_in) {
    case 1: return by_ns<ACT, 1>(ns, p, n_sub, bps, stream);
    case 2: return by_ns<ACT, 2>(ns, p, n_sub, bps, stream);
    case 3: return by_ns<ACT, 3>(ns, p, n_sub, bps, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int act, int d_in, int ns, const Params* p, int n_sub,
                     int* bps, cudaStream_t stream) {
  switch (act) {
    case 0: return by_d_in<0>(d_in, ns, p, n_sub, bps, stream);
    case 1: return by_d_in<1>(d_in, ns, p, n_sub, bps, stream);
    case 2: return by_d_in<2>(d_in, ns, p, n_sub, bps, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int n_sub, int n_pts, int d_in, int wp, int n_layers, int n_out,
              int n_sel) {
  return n_sub > 0 && n_pts > 0 && d_in >= 1 && d_in <= 3 && wp > 0 &&
         wp % 4 == 0 && n_layers >= 0 && n_out > 0 && n_out <= wp &&
         n_sel >= 0 && n_sel <= d_in;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Tile rows and blocks per subdomain for a launch of pinn_mlp_bwd; the
// partials take n_sub * blocks * pinn_mlp_bwd_part_len(...) floats.
int pinn_mlp_bwd_plan(int n_sub, int n_pts, int d_in, int wp, int n_layers,
                      int n_out, int act, int n_sel, int* tile_m,
                      int* blocks) {
  if (!shape_ok(n_sub, n_pts, d_in, wp, n_layers, n_out, n_sel))
    return (int)cudaErrorInvalidValue;
  const int tm = pick_tile(1 + d_in + n_sel, wp);
  if (tm == 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.wp = wp;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = dispatch(act, d_in, n_sel, &p, n_sub, &per_sm, nullptr);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many blocks per subdomain as the card holds resident at once, at
  // most one per tile
  const int n_tiles = (n_pts + tm - 1) / tm;
  const int wave = (per_sm * sms + n_sub - 1) / n_sub;
  *tile_m = tm;
  *blocks = n_tiles < wave ? n_tiles : wave;
  return 0;
}

long long pinn_mlp_bwd_part_len(int n_layers, int wp) {
  return (long long)part_len(n_layers, wp);
}

int pinn_mlp_bwd(const void* x, const void* w, const void* a, const void* res,
                 const void* cu, const void* cdu, const void* cd2u, void* cx,
                 void* cw, void* cb, void* ca, void* part, int n_sub,
                 int n_pts, int d_in, int wp, int n_layers, int n_out,
                 int act, int n_sel, int sel0, int sel1, int sel2,
                 int tile_m, int blocks, void* stream) {
  if (!shape_ok(n_sub, n_pts, d_in, wp, n_layers, n_out, n_sel) ||
      (n_sel > 0 && cd2u == nullptr) ||
      tile_m != pick_tile(1 + d_in + n_sel, wp) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  // the bulk copies and the float4 partial stores need 16-byte alignment
  if (!aligned16(w) || !aligned16(res) || !aligned16(part))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.a = static_cast<const float*>(a);
  p.res = static_cast<const float*>(res);
  p.cu = static_cast<const float*>(cu);
  p.cdu = static_cast<const float*>(cdu);
  p.cd2u = static_cast<const float*>(cd2u);
  p.cx = static_cast<float*>(cx);
  p.part = static_cast<float*>(part);
  p.n_pts = n_pts;
  p.wp = wp;
  p.n_layers = n_layers;
  p.n_out = n_out;
  p.tile_m = tile_m;
  p.n_tiles = (n_pts + tile_m - 1) / tile_m;
  p.n_blocks = blocks;
  p.ksplit = pick_split(1 + d_in + n_sel, tile_m, wp);
  if (blocks > p.n_tiles) return (int)cudaErrorInvalidValue;
  const int sel[3] = {sel0, sel1, sel2};
  bool seen[3] = {false, false, false};
  for (int k = 0; k < 3; ++k) {
    p.sel[k] = 0;
    if (k >= n_sel) continue;
    if (sel[k] < 0 || sel[k] >= d_in || seen[sel[k]])
      return (int)cudaErrorInvalidValue;
    seen[sel[k]] = true;
    p.sel[k] = sel[k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dispatch(act, d_in, n_sel, &p, n_sub, nullptr, st);
  if (e != cudaSuccess) return (int)e;
  const size_t len = part_len(n_layers, wp);
  const unsigned per = 256 / kGroups;
  const dim3 grid((unsigned)((len + per - 1) / per), n_sub);
  pinn_mlp_bwd_reduce<<<grid, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(cw),
      static_cast<float*>(cb), static_cast<float*>(ca), blocks, n_layers, wp);
  return (int)cudaGetLastError();
}

const char* pinn_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
