// PINN-MLP derivative forward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the reference package's Pallas TPU kernels
//   K1  src/repro/kernels/pinn_mlp.py::_kernel   (u and du/dx_j)
//   K2  src/repro/kernels/pinn_mlp.py::_kernel2  (u, du/dx_j and d2u/dx_j^2;
//       the recurrence is _kernel2_run)
//   K3  src/repro/kernels/pinn_mlp.py::_kernel2_res (K2 plus the spills of
//       the reverse sweep, the training forward)
// with one templated kernel: template parameters are the activation
// (0 tanh, 1 sin, 2 cos), d_in (1-3), NS, the number of second-order
// tangent streams kept, and SAVE.  NS == 0 is K1's counterpart; NS > 0 is
// K2's, with the s-streams of directions outside d2_dirs skipped (their d2u
// rows are written as exact zeros).  SAVE adds K3's spills; the tangent
// math is the same code either way, as _kernel2_run is one copy for K2 and
// K3.
//
// Spills (SAVE): before activation stage l a block writes the streams it
// holds, the ones ENTERING the stage, to
//   res (n_sub, n_layers, S, n_pts, wp),  S = 1 + d_in + NS,
// stream order h, t_0..t_{d_in-1}, then the kept s_k (k-th entry of
// d2_dirs).  Each (stream, tile) is a contiguous run of rows x wp floats;
// the reverse sweep (pinn_mlp_bwd.cu) reads the same runs.  With NS == 0
// only h and t are spilled.
//
// What bounds it on this card.  Per point and layer the matrix work is
// S * 2 * W_in * W_out FLOP; the bytes are x in, (1 + d_in + [d_in]) * n_out
// floats out and, with SAVE, the spills (1.5 KB per point at width 24 x 4,
// S = 4).  At the quickstart's training megabatch (n_sub 4 x 1120 rows,
// 24 x 4) the spill bytes bound K3 at 2.1 us; at 80 x 5 the FP32 FMAs bound
// it at 13.8 us (67 TFLOP/s).  The first version of this kernel reached 11 %
// of either bound (NVIDIA H100 80GB HBM3, 700 W): 128 threads and one
// 32-row tile per block gave about one block, 4 warps, per SM with nothing
// to hide the latency of the per-layer weight restaging behind a barrier;
// each thread owned one output column and read a float4 of activations per
// 4 FMAs; the spills were scalar stores.  The same kernel at 256 threads and
// 16-row tiles was 1.3-1.4x faster on the card, which confirmed the
// diagnosis before this design.  This one reaches 22 % and 27 %: at the
// quickstart's shape only 96 of a block's 256 threads have a micro-tile or
// a float4 of the activation stage, and a layer is two barriers and a few
// hundred dependent cycles; at 80 x 5 the blocks restage 29 MB of weights
// from L2.
//
// Design.  Grid = (point tiles, n_sub), 256 threads, three blocks resident
// per SM where shared memory allows and S <= 4 (registers capped at 80
// for it; two for more streams): a block walks the layer stack for tile_m
// rows of ONE subdomain (this replaces the reference's vmap over
// pallas_call).  tile_m is the multiple of 4 up to 32 whose grid takes the
// fewest waves of resident blocks, weighed by the rows each block walks
// (pick_tile: 12 rows, 376 blocks in one wave, at the quickstart's shape;
// 20 at 80 x 5).  The streams h, t_j, s_k of the tile live in shared memory
// as one stacked (S * tile_m) x wp matrix, double-buffered (in -> out per
// affine layer).  Per hidden layer:
//   1. activation, elementwise and in place on float4s, in the order of
//      _kernel2_run (with SAVE the float4s entering it are first stored to
//      the spill runs by 16-byte coalesced stores, which no later
//      instruction waits on; the s-stream's t_{sel[k]} is picked by a
//      one-hot blend, which keeps the float4s in registers):
//        s <- phi''(a h) a^2 t^2 + phi'(a h) a s   (before t is overwritten)
//        t <- phi'(a h) a t
//        h <- phi(a h)
//   2. affine layer on the stacked streams: out = in W (+ b on the h rows),
//      a register micro-tile of 4 stacked rows x 4 columns per thread fed by
//      float4 loads of both operands (16 FMAs per 2 loads).  A thread's rows
//      are strided by a quarter of the stacked height, so neighbouring lanes
//      read neighbouring rows (distinct banks).
// The weights of layer l + 1 arrive by one bulk copy (cp.async.bulk,
// completing on an mbarrier) into the second of two weight buffers, issued
// while layer l computes.  The input layer is h = x W0 + b0, t_j = row j of
// W0, s = 0.
//
// Precision: plain IEEE FP32 (fmaf, tanhf/sinf/cosf, no fast math, no TF32),
// so the result matches the FP32 plain version to ~1e-5.  Each output sums
// its products in ascending k, as the first version did.  Widths are padded
// with zeros to a multiple of 4 (not to the TPU's 128 lanes); padding is
// exact because the padded rows of the following weight matrix are zero.
//
// C interface (bound with ctypes): pinn_mlp_fwd(...) launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;           // resident blocks per SM aimed at
constexpr size_t kSmemMax = 232448;     // dynamic shared memory per block
constexpr size_t kSmemSM = 233472;      // shared memory per SM
constexpr size_t kSmemReserve = 1024;   // reserved per resident block
constexpr int kBarBytes = 16;           // two mbarriers ahead of the floats

struct Params {
  const float* x;   // (n_sub, n_pts, d_in)
  const float* w;   // (n_sub, n_layers + 1, wp, wp), zero padded
  const float* b;   // (n_sub, n_layers + 1, wp)
  const float* a;   // (n_sub, n_layers + 1) slopes (last entry unused)
  float* u;         // (n_sub, n_pts, n_out)
  float* du;        // (n_sub, d_in, n_pts, n_out)
  float* d2u;       // (n_sub, d_in, n_pts, n_out); unused when NS == 0
  float* res;       // (n_sub, n_layers, S, n_pts, wp) spills; SAVE only
  int n_pts, wp, n_layers, n_out, tile_m;
  int sel[3];       // s-stream k carries direction sel[k]
  int slot[3];      // direction j -> its s-stream, -1 when pruned
};

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
// set component c (a constant after unrolling) of a float4
__device__ __forceinline__ void set(float4& v, int c, float x) {
  if (c == 0) v.x = x; else if (c == 1) v.y = x; else if (c == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ float pick(int sel, int j) {
  return sel == j ? 1.f : 0.f;
}

template <int ACT>
__device__ __forceinline__ void act_eval(float z, float& g, float& d1,
                                         float& d2) {
  if constexpr (ACT == 0) {
    const float th = tanhf(z);
    g = th;
    d1 = 1.0f - th * th;
    d2 = -2.0f * th * (1.0f - th * th);
  } else if constexpr (ACT == 1) {
    g = sinf(z);
    d1 = cosf(z);
    d2 = -g;
  } else {
    g = cosf(z);
    d1 = -sinf(z);
    d2 = -g;
  }
}

// kMinBlocks resident blocks per SM (80 registers a thread) for up to four
// streams; two for more, whose activation stage would spill at 80
template <int ACT, int D_IN, int NS, bool SAVE>
__global__ void __launch_bounds__(kThreads,
                                  1 + D_IN + NS <= 4 ? kMinBlocks : 2)
pinn_mlp_fwd_kernel(const Params p) {
  constexpr int S = 1 + D_IN + NS;  // streams: h, t_0..t_{d_in-1}, s_0..
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wp = p.wp, tm = p.tile_m, L = p.n_layers, tid = threadIdx.x;
  const int plane = tm * wp;  // one stream's tile
  const int wsz = wp * wp;
  const uint32_t bar0 = smem_u32(smem_raw);
  float* in = reinterpret_cast<float*>(smem_raw + kBarBytes);
  float* out = in + S * plane;
  float* wbuf = out + S * plane;  // two weight buffers of wp x wp

  const int q = blockIdx.y;
  const int row0 = blockIdx.x * tm;
  const int rows = min(tm, p.n_pts - row0);
  const float* W = p.w + (size_t)q * (L + 1) * wsz;
  const float* B = p.b + (size_t)q * (L + 1) * wp;
  const float* A = p.a + (size_t)q * (L + 1);
  const float* X = p.x + ((size_t)q * p.n_pts + row0) * D_IN;

  // W_j goes to buffer j & 1 and is its ((j - 1) >> 1)-th fill
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (L > 0) {
      mbar_expect_tx(bar0 + 8, wsz * 4);
      bulk_load(smem_u32(wbuf + wsz), W + wsz, wsz * 4, bar0 + 8);
    }
  }

  // input affine layer; rows past the ragged tail run on x = 0 and are
  // never stored
  for (int i = tid; i < plane; i += kThreads) {
    const int r = i / wp, c = i - r * wp;
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < D_IN; ++j)
        acc = fmaf(X[r * D_IN + j], W[j * wp + c], acc);
    }
    in[i] = acc + B[c];
#pragma unroll
    for (int j = 0; j < D_IN; ++j) in[(1 + j) * plane + i] = W[j * wp + c];
#pragma unroll
    for (int k = 0; k < NS; ++k) in[(1 + D_IN + k) * plane + i] = 0.f;
  }

  const int nrg = S * tm / 4;  // row groups of the stacked streams
  for (int l = 0; l < L; ++l) {
    const int j = l + 1;                        // the affine layer
    const int n = (j == L) ? p.n_out : wp;      // its output columns
    __syncthreads();  // `in` complete; the buffer of W_{j+1} no longer read
    if (tid == 0 && j < L) {
      const uint32_t bar = bar0 + 8 * ((j + 1) & 1);
      mbar_expect_tx(bar, wsz * 4);
      bulk_load(smem_u32(wbuf + ((j + 1) & 1) * wsz), W + (size_t)(j + 1) *
                wsz, wsz * 4, bar);
    }
    // 1. activation stage on float4s, in place; with SAVE the streams
    //    entering it are stored first (rows past the tail are not)
    const float al = A[l];
    float* spill = nullptr;
    size_t sstride = 0;
    if constexpr (SAVE) {
      sstride = (size_t)p.n_pts * wp;
      spill = p.res + ((size_t)q * L + l) * S * sstride + (size_t)row0 * wp;
    }
    for (int i = 4 * tid; i < plane; i += 4 * kThreads) {
      float4 v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = ld4(in + s * plane + i);
      if constexpr (SAVE) {
        if (i < rows * wp) {
#pragma unroll
          for (int s = 0; s < S; ++s) st4(spill + s * sstride + i, v[s]);
        }
      }
      // in place, one component at a time: s first (it reads the old t),
      // then t, then h
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float g, f1, f2;
        act_eval<ACT>(al * comp(v[0], c), g, f1, f2);
        const float d1 = f1 * al, d2 = f2 * (al * al);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          // t_{sel[k]} by a one-hot blend: exact, and no indexed (local)
          // array
          float t = 0.f;
#pragma unroll
          for (int jj = 0; jj < D_IN; ++jj)
            t = fmaf(pick(p.sel[k], jj), comp(v[1 + jj], c), t);
          set(v[1 + D_IN + k], c, d2 * t * t + d1 * comp(v[1 + D_IN + k], c));
        }
#pragma unroll
        for (int jj = 0; jj < D_IN; ++jj)
          set(v[1 + jj], c, comp(v[1 + jj], c) * d1);
        set(v[0], c, g);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) st4(in + s * plane + i, v[s]);
    }
    mbar_wait(bar0 + 8 * (j & 1), ((j - 1) >> 1) & 1);
    __syncthreads();
    // 2. affine layer j on the stacked streams: 4 rows (strided by nrg) x
    //    4 columns per task
    const float* sw = wbuf + (j & 1) * wsz;
    const float* bl = B + (size_t)j * wp;
    const int ncg = (n + 3) / 4;
    for (int task = tid; task < nrg * ncg; task += kThreads) {
      const int rg = task / ncg, c0 = 4 * (task - rg * ncg);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
      for (int k = 0; k < wp; k += 4) {
        float4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = ld4(in + (rg + i * nrg) * wp + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w4 = ld4(sw + (k + kk) * wp + c0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = comp(av[i], kk);
            acc[i][0] = fmaf(xv, w4.x, acc[i][0]);
            acc[i][1] = fmaf(xv, w4.y, acc[i][1]);
            acc[i][2] = fmaf(xv, w4.z, acc[i][2]);
            acc[i][3] = fmaf(xv, w4.w, acc[i][3]);
          }
        }
      }
      const float4 b4 = ld4(bl + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int R = rg + i * nrg;
        if (R < tm) {  // the h rows take the bias
          acc[i][0] += b4.x;
          acc[i][1] += b4.y;
          acc[i][2] += b4.z;
          acc[i][3] += b4.w;
        }
        st4(out + R * wp + c0,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    float* tmp = in;
    in = out;
    out = tmp;
  }

  __syncthreads();
  const int n_out = p.n_out;
  for (int i = tid; i < rows * n_out; i += kThreads) {
    const int r = i / n_out, c = i - r * n_out;
    const int li = r * wp + c;
    const size_t pt = (size_t)row0 + r;
    p.u[((size_t)q * p.n_pts + pt) * n_out + c] = in[li];
#pragma unroll
    for (int j = 0; j < D_IN; ++j) {
      const size_t o = (((size_t)q * D_IN + j) * p.n_pts + pt) * n_out + c;
      p.du[o] = in[(1 + j) * plane + li];
      if constexpr (NS > 0) {
        const int k = p.slot[j];
        p.d2u[o] = k >= 0 ? in[(1 + D_IN + k) * plane + li] : 0.f;
      }
    }
  }
}

size_t smem_bytes(int s, int tm, int wp) {
  return kBarBytes +
         (2 * (size_t)s * tm * wp + 2 * (size_t)wp * wp) * sizeof(float);
}

int blocks_by_smem(size_t smem) {
  return (int)(kSmemSM / (smem + kSmemReserve));
}

// Rows per block: the multiple of 4 up to 32 whose grid takes the fewest
// waves of resident blocks, weighed by the rows a block walks plus
// kTileCost for what a block pays whatever its rows (the weights' copies,
// the barriers): cost = waves * (tile_m + kTileCost).  Resident blocks per
// SM: the launch bounds' guarantee (kMinBlocks, 2 above four streams) or
// what shared memory allows, whichever is less.  0 when nothing fits.
constexpr int kTileCost = 8;

int pick_tile(int s, int wp, int n_sub, int n_pts, int sms) {
  int best = 0;
  long long best_cost = 0;
  for (int tm = 4; tm <= 32; tm += 4) {
    const size_t smem = smem_bytes(s, tm, wp);
    if (smem > kSmemMax) break;
    int bps = blocks_by_smem(smem);
    const int regs_bps = s <= 4 ? kMinBlocks : 2;
    if (bps > regs_bps) bps = regs_bps;
    const long long blocks = (long long)n_sub * ((n_pts + tm - 1) / tm);
    const long long slots = (long long)bps * sms;
    const long long cost = (blocks + slots - 1) / slots * (tm + kTileCost);
    if (best == 0 || cost < best_cost) {
      best = tm;
      best_cost = cost;
    }
  }
  return best;
}

template <int ACT, int D_IN, int NS, bool SAVE>
cudaError_t launch(const Params& p, int n_sub, size_t smem,
                   cudaStream_t stream) {
  auto kern = pinn_mlp_fwd_kernel<ACT, D_IN, NS, SAVE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n_pts + p.tile_m - 1) / p.tile_m, n_sub);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ACT, int D_IN, int NS = 0>
cudaError_t by_ns(int ns, const Params& p, int n_sub, size_t smem,
                  cudaStream_t stream) {
  if constexpr (NS > D_IN) {
    return cudaErrorInvalidValue;
  } else {
    if (ns == NS) {
      return p.res != nullptr
                 ? launch<ACT, D_IN, NS, true>(p, n_sub, smem, stream)
                 : launch<ACT, D_IN, NS, false>(p, n_sub, smem, stream);
    }
    return by_ns<ACT, D_IN, NS + 1>(ns, p, n_sub, smem, stream);
  }
}

template <int ACT>
cudaError_t by_d_in(int d_in, int ns, const Params& p, int n_sub, size_t smem,
                    cudaStream_t stream) {
  switch (d_in) {
    case 1: return by_ns<ACT, 1>(ns, p, n_sub, smem, stream);
    case 2: return by_ns<ACT, 2>(ns, p, n_sub, smem, stream);
    case 3: return by_ns<ACT, 3>(ns, p, n_sub, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// res == nullptr: K1/K2; res != nullptr: K3, which also writes the spills
int pinn_mlp_fwd(const void* x, const void* w, const void* b, const void* a,
                 void* u, void* du, void* d2u, void* res, int n_sub,
                 int n_pts, int d_in, int wp, int n_layers, int n_out,
                 int act, int n_sel, int sel0, int sel1, int sel2,
                 void* stream) {
  if (n_sub <= 0 || n_pts <= 0 || d_in < 1 || d_in > 3 || wp <= 0 ||
      wp % 4 != 0 || n_layers < 0 || n_out <= 0 || n_out > wp ||
      n_sel < 0 || n_sel > d_in || (n_sel > 0 && d2u == nullptr))
    return (int)cudaErrorInvalidValue;
  // the bulk copies of W, the float4 loads of b and the float4 spill
  // stores need 16-byte aligned rows
  if (!aligned16(w) || !aligned16(b) || (res != nullptr && !aligned16(res)))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.a = static_cast<const float*>(a);
  p.u = static_cast<float*>(u);
  p.du = static_cast<float*>(du);
  p.d2u = static_cast<float*>(d2u);
  p.res = static_cast<float*>(res);
  p.n_pts = n_pts;
  p.wp = wp;
  p.n_layers = n_layers;
  p.n_out = n_out;
  const int sel[3] = {sel0, sel1, sel2};
  for (int j = 0; j < 3; ++j) p.slot[j] = -1;
  for (int k = 0; k < 3; ++k) {
    p.sel[k] = 0;
    if (k >= n_sel) continue;
    if (sel[k] < 0 || sel[k] >= d_in || p.slot[sel[k]] >= 0)
      return (int)cudaErrorInvalidValue;
    p.sel[k] = sel[k];
    p.slot[sel[k]] = k;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int s = 1 + d_in + n_sel;
  p.tile_m = pick_tile(s, wp, n_sub, n_pts, sms);
  if (p.tile_m == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, p.tile_m, wp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return (int)by_d_in<0>(d_in, n_sel, p, n_sub, smem, st);
    case 1: return (int)by_d_in<1>(d_in, n_sel, p, n_sub, smem, st);
    case 2: return (int)by_d_in<2>(d_in, n_sel, p, n_sub, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pinn_mlp_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
