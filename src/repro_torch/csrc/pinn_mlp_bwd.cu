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
// Design.  Grid = (blocks per subdomain, n_sub).  A block owns a contiguous
// range of row tiles (tile_m rows) of one subdomain and walks them in
// order; per tile it walks the layers backward with the cotangent streams
// (h-bar, t-bar_j, s-bar_k) in shared memory, staging W_{l+1} transposed
// one layer at a time.  Per layer: (1) load the tile's spills of stage l
// and form the streams entering affine layer l+1 (g, t~, s~); (2) add
// g^T h-bar + ... into the block's W-bar slice and sum h-bar into b-bar;
// (3) pull the cotangents through W^T; (4) the activation stage, with
// a-bar's share of every thread summed by a fixed-shape tree in shared
// memory.
//
// Cross-block reduction.  The TPU kernel adds W-bar, b-bar and a-bar into
// one output block over a sequential grid.  Hopper blocks run in no order,
// so each block adds into its own partial slice (n_sub, blocks, E floats;
// no other block touches it, no atomics), and a second kernel here sums
// the partials of each subdomain in block order.  The tile partition and
// every summation order depend only on the shapes and the card's SM count,
// so two launches on the same inputs give bitwise equal results.  The
// number of blocks per subdomain is fixed (one wave at full occupancy,
// divided among the subdomains), not one per tile, so the partials stay
// small: at width 128, depth 5 they are 393 KB per block whatever the
// number of points.
//
// What bounds it on this card.  It reads the same spills the forward wrote
// (1.5 KB per point at width 24, depth 4, S = 4) and does about twice the
// forward's matrix FLOPs (the W-bar products and the W^T products), so at
// the 2x2 Burgers training shape (~4.6k rows) the bound is about 2.1 us of
// spill bytes; in practice launch latency bounds it there.  At widths
// 80-128 it is FP32-FMA bound, like the forward.
//
// Precision: plain IEEE FP32 (fmaf, tanhf/sinf/cosf, no fast math, no TF32,
// no float atomics).
//
// C interface (bound with ctypes): pinn_mlp_bwd_plan(...) picks the tile and
// the number of blocks per subdomain (the caller sizes the partials with
// them); pinn_mlp_bwd(...) launches the sweep and the reduction on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;             // rows per thread in the W^T products
constexpr size_t kSmemMax = 232448;  // dynamic shared memory per block

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
  int n_pts, wp, n_layers, n_out, tile_m, n_tiles, n_blocks;
  int sel[3];         // s-stream k carries direction sel[k]
};

// floats of one block's partial slice: W-bar, b-bar, a-bar stacks
__host__ __device__ inline size_t part_len(int n_layers, int wp) {
  const size_t l1 = (size_t)n_layers + 1;
  return l1 * wp * wp + l1 * wp + l1;
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

template <int ACT, int D_IN, int NS>
__global__ void __launch_bounds__(kThreads)
pinn_mlp_bwd_kernel(const Params p) {
  constexpr int S = 1 + D_IN + NS;  // streams: h, t_0..t_{d_in-1}, s_0..
  extern __shared__ __align__(16) float smem[];
  const int wp = p.wp, tm = p.tile_m, L = p.n_layers, tid = threadIdx.x;
  const int plane = tm * wp;
  float* F = smem;                 // spilled streams of the stage
  float* G = F + S * plane;        // streams entering the affine layer,
                                   // then the cotangents times W^T
  float* Bar = G + S * plane;      // cotangent streams
  float* sWT = Bar + S * plane;    // W_{l+1} transposed: sWT[c * wp + k]
  float* red = sWT + wp * wp;      // kThreads floats for the a-bar tree

  const int q = blockIdx.y, blk = blockIdx.x;
  const int tile0 = (int)((long long)blk * p.n_tiles / p.n_blocks);
  const int tile1 = (int)((long long)(blk + 1) * p.n_tiles / p.n_blocks);
  const size_t wsz = (size_t)wp * wp;
  const size_t pstride = (size_t)p.n_pts * wp;  // one spilled stream
  const float* W = p.w + (size_t)q * (L + 1) * wsz;
  const float* A = p.a + (size_t)q * (L + 1);
  const float* X = p.x + (size_t)q * p.n_pts * D_IN;
  float* Pw = p.part + ((size_t)q * p.n_blocks + blk) * part_len(L, wp);
  float* Pb = Pw + (size_t)(L + 1) * wsz;
  float* Pa = Pb + (size_t)(L + 1) * wp;

  for (int tile = tile0; tile < tile1; ++tile) {
    const bool first = tile == tile0;
    const int row0 = tile * tm;
    const int rows = min(tm, p.n_pts - row0);
    __syncthreads();  // the previous tile is done with shared memory
    // cotangents of the outputs; padded columns and the ragged tail are 0
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
      for (int k = 0; k < NS; ++k) {
        const size_t o =
            (((size_t)q * D_IN + p.sel[k]) * p.n_pts + pt) * p.n_out + c;
        Bar[(1 + D_IN + k) * plane + i] = live ? p.cd2u[o] : 0.f;
      }
    }

    for (int l = L - 1; l >= 0; --l) {
      __syncthreads();  // Bar complete; F, G and sWT free
      const float* Wl = W + (size_t)(l + 1) * wsz;
      for (int i = tid; i < (int)wsz; i += kThreads) {
        const int k = i / wp, c = i - k * wp;
        sWT[c * wp + k] = Wl[i];
      }
      // (1) spills of stage l, and the streams entering affine layer l+1
      const float al = A[l];
      const float* R = p.res + ((size_t)q * L + l) * S * pstride +
                       (size_t)row0 * wp;
      for (int i = tid; i < plane; i += kThreads) {
        const bool live = i < rows * wp;
        float v[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          v[s] = live ? R[s * pstride + i] : 0.f;
          F[s * plane + i] = v[s];
        }
        float g, p1, p2, p3;
        act_eval<ACT>(al * v[0], g, p1, p2, p3);
        const float d1 = p1 * al, d2 = p2 * (al * al);
        G[i] = g;
#pragma unroll
        for (int j = 0; j < D_IN; ++j) G[(1 + j) * plane + i] = d1 * v[1 + j];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < D_IN; ++j)
            if (p.sel[k] == j) t = v[1 + j];
          G[(1 + D_IN + k) * plane + i] = d2 * t * t + d1 * v[1 + D_IN + k];
        }
      }
      __syncthreads();
      // (2) W-bar_{l+1} += sum_s G_s^T Bar_s (4 rows k per thread); b-bar
      float* Pwl = Pw + (size_t)(l + 1) * wsz;
      for (int task = tid; task < (wp / 4) * wp; task += kThreads) {
        const int k0 = (task / wp) * 4, c = task - (task / wp) * wp;
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          for (int r = 0; r < rows; ++r) {
            const float bv = Bar[s * plane + r * wp + c];
            const float4 gv =
                *reinterpret_cast<const float4*>(G + s * plane + r * wp + k0);
            acc0 = fmaf(gv.x, bv, acc0);
            acc1 = fmaf(gv.y, bv, acc1);
            acc2 = fmaf(gv.z, bv, acc2);
            acc3 = fmaf(gv.w, bv, acc3);
          }
        }
        put(Pwl + (size_t)(k0 + 0) * wp + c, acc0, first);
        put(Pwl + (size_t)(k0 + 1) * wp + c, acc1, first);
        put(Pwl + (size_t)(k0 + 2) * wp + c, acc2, first);
        put(Pwl + (size_t)(k0 + 3) * wp + c, acc3, first);
      }
      for (int c = tid; c < wp; c += kThreads) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) acc += Bar[r * wp + c];
        put(Pb + (size_t)(l + 1) * wp + c, acc, first);
      }
      __syncthreads();  // G read; it now takes the W^T products
      // (3) every cotangent stream times W_{l+1}^T, into G
      for (int task = tid; task < (tm / kRows) * wp; task += kThreads) {
        const int grp = task / wp, k = task - grp * wp;
        const float* src = Bar + grp * kRows * wp;
        float acc[S][kRows];
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[s][r] = 0.f;
        for (int c = 0; c < wp; c += 4) {
          const float w0 = sWT[(c + 0) * wp + k], w1 = sWT[(c + 1) * wp + k];
          const float w2 = sWT[(c + 2) * wp + k], w3 = sWT[(c + 3) * wp + k];
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 v = *reinterpret_cast<const float4*>(
                  src + s * plane + r * wp + c);
              float t = acc[s][r];
              t = fmaf(v.x, w0, t);
              t = fmaf(v.y, w1, t);
              t = fmaf(v.z, w2, t);
              t = fmaf(v.w, w3, t);
              acc[s][r] = t;
            }
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            G[s * plane + (grp * kRows + r) * wp + k] = acc[s][r];
      }
      __syncthreads();
      // (4) activation stage l: F (h, t, s) and G (the pulled-back
      //     cotangents) give the new Bar and this thread's share of a-bar_l
      float ca = 0.f;
      for (int i = tid; i < plane; i += kThreads) {
        const float h = F[i];
        float g, p1, p2, p3;
        act_eval<ACT>(al * h, g, p1, p2, p3);
        const float d1 = p1 * al, d2 = p2 * (al * al);
        const float p3a3 = p3 * (al * al * al);
        const float e1 = p2 * h * al + p1;
        const float e2 = p3 * h * (al * al) + 2.0f * p2 * al;
        const float bg = G[i];
        float cai = bg * (p1 * h);
        float nh = bg * d1;
        float nt[D_IN];
#pragma unroll
        for (int j = 0; j < D_IN; ++j) {
          const float bt = G[(1 + j) * plane + i];
          const float t = F[(1 + j) * plane + i];
          cai = fmaf(bt * t, e1, cai);
          nh = fmaf(bt * t, d2, nh);
          nt[j] = bt * d1;
        }
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const float bs = G[(1 + D_IN + k) * plane + i];
          const float s = F[(1 + D_IN + k) * plane + i];
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < D_IN; ++j)
            if (p.sel[k] == j) t = F[(1 + j) * plane + i];
          cai = fmaf(bs, t * t * e2 + s * e1, cai);
          nh = fmaf(bs, t * t * p3a3 + s * d2, nh);
#pragma unroll
          for (int j = 0; j < D_IN; ++j)
            if (p.sel[k] == j) nt[j] = fmaf(bs * (2.0f * d2), t, nt[j]);
          Bar[(1 + D_IN + k) * plane + i] = bs * d1;
        }
        Bar[i] = nh;
#pragma unroll
        for (int j = 0; j < D_IN; ++j) Bar[(1 + j) * plane + i] = nt[j];
        ca += cai;
      }
      // a-bar_l: fixed-shape tree over the block's threads
      red[tid] = ca;
      __syncthreads();
      for (int off = kThreads / 2; off > 0; off >>= 1) {
        if (tid < off) red[tid] += red[tid + off];
        __syncthreads();
      }
      if (tid == 0) put(Pa + l, red[0], first);
    }

    __syncthreads();
    // input layer: x-bar = h-bar W_0^T, W-bar_0 = x^T h-bar + row_j sum t-bar
    for (int i = tid; i < rows * D_IN; i += kThreads) {
      const int r = i / D_IN, j = i - r * D_IN;
      float acc = 0.f;
      for (int c = 0; c < wp; ++c)
        acc = fmaf(Bar[r * wp + c], W[j * wp + c], acc);
      p.cx[((size_t)q * p.n_pts + row0 + r) * D_IN + j] = acc;
    }
    for (int c = tid; c < wp; c += kThreads) {
      float hb = 0.f;
      for (int r = 0; r < rows; ++r) hb += Bar[r * wp + c];
      put(Pb + c, hb, first);
#pragma unroll
      for (int j = 0; j < D_IN; ++j) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r)
          acc = fmaf(X[(size_t)(row0 + r) * D_IN + j], Bar[r * wp + c], acc);
        float tb = 0.f;
        for (int r = 0; r < rows; ++r) tb += Bar[(1 + j) * plane + r * wp + c];
        put(Pw + (size_t)j * wp + c, acc + tb, first);
      }
      if (first) {  // rows of W_0 past d_in, and the unused last slope
        for (int j = D_IN; j < wp; ++j) Pw[(size_t)j * wp + c] = 0.f;
        if (c == 0) Pa[L] = 0.f;
      }
    }
  }
}

// Sum each subdomain's partials in block order into W-bar, b-bar, a-bar.
__global__ void __launch_bounds__(256)
pinn_mlp_bwd_reduce(const float* part, float* cw, float* cb, float* ca,
                    int n_blocks, int n_layers, int wp) {
  const int q = blockIdx.y;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t len = part_len(n_layers, wp);
  if (e >= len) return;
  const float* P = part + (size_t)q * n_blocks * len + e;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += P[(size_t)b * len];
  const size_t l1 = (size_t)n_layers + 1, nw = l1 * wp * wp, nb = l1 * wp;
  if (e < nw)
    cw[q * nw + e] = acc;
  else if (e < nw + nb)
    cb[q * nb + (e - nw)] = acc;
  else
    ca[q * l1 + (e - nw - nb)] = acc;
}

size_t smem_bytes(int s, int tm, int wp) {
  return (3 * (size_t)s * tm * wp + (size_t)wp * wp + kThreads) *
         sizeof(float);
}

// tile rows: the largest tile whose three stream buffers, one weight matrix
// and the a-bar tree fit a block's shared memory (0 when none fits)
int pick_tile(int s, int wp) {
  const int tiles[] = {32, 16, 8, 4};
  for (int tm : tiles)
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
  const dim3 grid((unsigned)((len + 255) / 256), n_sub);
  pinn_mlp_bwd_reduce<<<grid, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(cw),
      static_cast<float*>(cb), static_cast<float*>(ca), blocks, n_layers, wp);
  return (int)cudaGetLastError();
}

const char* pinn_mlp_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
