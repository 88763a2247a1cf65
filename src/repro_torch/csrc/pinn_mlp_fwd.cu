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
// d2_dirs).  Each (stream, tile) is a contiguous run of rows x wp floats,
// written row-major from the shared-memory tile, so the stores coalesce;
// the reverse sweep (pinn_mlp_bwd.cu) reads the same runs.  With NS == 0
// only h and t are spilled.
//
// What bounds it on this card: FP32 FMA throughput.  Per point and layer the
// matmul work is (1 + d_in + NS) * 2 * W_in * W_out FLOP, while the bytes
// moved are only x in (d_in floats) and (1 + d_in + [d_in]) * n_out floats
// out: weights are re-read per block from L2, and every activation and
// tangent stays on chip.  At serving batches of a few thousand points the
// whole call is a few microseconds of arithmetic, so launch latency bounds
// it there.  With SAVE the spills change that at small widths: at the
// training shape (wp = 24, 4 hidden layers, S = 4 for d_in = 2 and
// d2_dirs = (0,)) they are 1.5 KB per point, about 7 MB per step for the
// ~4.6k megabatch rows of a 2x2 Burgers XPINN, i.e. 2.1 us at 3.35 TB/s,
// against about 63 MFLOP, 0.9 us at 67 TFLOP/s: the spill bytes bound K3
// there (and at that size launch latency, ~15 us, bounds it in practice).
//
// Design.  Grid = (point tiles, n_sub): a block walks the whole layer stack
// for tile_m rows of ONE subdomain, reading that subdomain's packed weights
// (this replaces the reference's vmap over pallas_call).  The streams h, t_j,
// s_k of the tile live in shared memory (double-buffered: in -> out per
// affine layer), and one layer's weight matrix at a time is staged in shared
// memory (at width 128 that is 64 KB; the whole stack would not fit).  Per
// hidden layer:
//   1. activation, elementwise and in place, in the order of _kernel2_run:
//        s <- phi''(a h) a^2 t^2 + phi'(a h) a s   (before t is overwritten)
//        t <- phi'(a h) a t
//        h <- phi(a h)
//   2. affine layer on every stream: h <- h W + b, t <- t W, s <- s W.
//      Each thread owns kRows rows x 1 column x all streams in registers and
//      reads 4 inputs per shared load (float4).
// The input layer is h = x W0 + b0, t_j = row j of W0, s = 0.
//
// Precision: plain IEEE FP32 (fmaf, tanhf/sinf/cosf, no fast math, no TF32),
// so the result matches the FP32 plain version to ~1e-5.  Widths are padded
// with zeros to a multiple of 4 (not to the TPU's 128 lanes); padding is
// exact because the padded rows of the following weight matrix are zero.
//
// C interface (bound with ctypes): pinn_mlp_fwd(...) launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;   // rows per thread in the affine stage
constexpr size_t kSmemMax = 232448;  // dynamic shared memory per block

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

template <int ACT, int D_IN, int NS, bool SAVE>
__global__ void __launch_bounds__(kThreads)
pinn_mlp_fwd_kernel(const Params p) {
  constexpr int S = 1 + D_IN + NS;  // streams: h, t_0..t_{d_in-1}, s_0..
  extern __shared__ __align__(16) float smem[];
  const int wp = p.wp, tm = p.tile_m;
  const int plane = tm * wp;  // one stream's tile
  float* in = smem;
  float* out = smem + S * plane;
  float* sw = smem + 2 * S * plane;  // one layer's weights, (wp, n)

  const int q = blockIdx.y;
  const int row0 = blockIdx.x * tm;
  const int rows = min(tm, p.n_pts - row0);
  const size_t wsz = (size_t)wp * wp;
  const float* W = p.w + (size_t)q * (p.n_layers + 1) * wsz;
  const float* B = p.b + (size_t)q * (p.n_layers + 1) * wp;
  const float* A = p.a + (size_t)q * (p.n_layers + 1);
  const float* X = p.x + ((size_t)q * p.n_pts + row0) * D_IN;

  // input affine layer; rows past the ragged tail run on x = 0 and are
  // never stored
  for (int i = threadIdx.x; i < plane; i += kThreads) {
    const int r = i / wp, c = i - r * wp;
    float acc = 0.f;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < D_IN; ++j) acc = fmaf(X[r * D_IN + j], W[j * wp + c], acc);
    }
    in[i] = acc + B[c];
#pragma unroll
    for (int j = 0; j < D_IN; ++j) in[(1 + j) * plane + i] = W[j * wp + c];
#pragma unroll
    for (int k = 0; k < NS; ++k) in[(1 + D_IN + k) * plane + i] = 0.f;
  }

  for (int l = 0; l < p.n_layers; ++l) {
    const int n = (l + 1 == p.n_layers) ? p.n_out : wp;  // output columns
    __syncthreads();  // `in` complete; `sw` no longer read
    const float* Wl = W + (size_t)(l + 1) * wsz;
    for (int i = threadIdx.x; i < wp * n; i += kThreads) {
      const int k = i / n, c = i - k * n;
      sw[i] = Wl[k * wp + c];
    }
    // 1. activation stage, elementwise and in place; with SAVE the streams
    //    entering it are spilled first (rows past the tail are not)
    const float al = A[l];
    float* spill = nullptr;
    size_t sstride = 0;
    if constexpr (SAVE) {
      sstride = (size_t)p.n_pts * wp;
      spill = p.res + ((size_t)q * p.n_layers + l) * S * sstride +
              (size_t)row0 * wp;
    }
    for (int i = threadIdx.x; i < plane; i += kThreads) {
      if constexpr (SAVE) {
        if (i < rows * wp) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            spill[s * sstride + i] = in[s * plane + i];
        }
      }
      float g, f1, f2;
      act_eval<ACT>(al * in[i], g, f1, f2);
      const float d1 = f1 * al, d2 = f2 * (al * al);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float t = in[(1 + p.sel[k]) * plane + i];
        float& s = in[(1 + D_IN + k) * plane + i];
        s = d2 * t * t + d1 * s;
      }
#pragma unroll
      for (int j = 0; j < D_IN; ++j) in[(1 + j) * plane + i] *= d1;
      in[i] = g;
    }
    __syncthreads();
    // 2. affine layer l + 1 on every stream
    const float* bl = B + (size_t)(l + 1) * wp;
    const int tasks = (tm / kRows) * n;
    for (int task = threadIdx.x; task < tasks; task += kThreads) {
      const int grp = task / n, c = task - grp * n;
      const float* src = in + grp * kRows * wp;
      float acc[S][kRows];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[s][r] = 0.f;
      for (int k = 0; k < wp; k += 4) {
        const float w0 = sw[(k + 0) * n + c], w1 = sw[(k + 1) * n + c];
        const float w2 = sw[(k + 2) * n + c], w3 = sw[(k + 3) * n + c];
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(src + s * plane + r * wp + k);
            float t = acc[s][r];
            t = fmaf(v.x, w0, t);
            t = fmaf(v.y, w1, t);
            t = fmaf(v.z, w2, t);
            t = fmaf(v.w, w3, t);
            acc[s][r] = t;
          }
        }
      }
      const float bias = bl[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[0][r] += bias;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          out[s * plane + (grp * kRows + r) * wp + c] = acc[s][r];
    }
    float* tmp = in;
    in = out;
    out = tmp;
  }

  __syncthreads();
  const int n_out = p.n_out;
  for (int i = threadIdx.x; i < rows * n_out; i += kThreads) {
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
  // rows per block: the largest tile whose streams (double buffered) plus
  // one weight matrix fit a block's shared memory
  size_t smem = 0;
  p.tile_m = 0;
  const int tiles[] = {32, 16, 8, 4};
  for (int tm : tiles) {
    smem = (2 * (size_t)(1 + d_in + n_sel) * tm * wp + (size_t)wp * wp) *
           sizeof(float);
    if (smem <= kSmemMax) {
      p.tile_m = tm;
      break;
    }
  }
  if (p.tile_m == 0) return (int)cudaErrorInvalidValue;
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
