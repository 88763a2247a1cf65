// RWKV-6 ("Finch") chunked WKV forward for Hopper (sm_90a), CUDA C++ on the
// CUDA cores: a chunk kernel, a scan kernel and an output kernel behind one
// call.
//
// Replaces the reference package's Pallas TPU kernel
//   K6  src/repro/kernels/wkv6.py::_kernel  (launched by wkv6_pallas,
//       wrapped by kernels/ops.py::wkv6)
// and serves the port's rwkv6 prefill: every time-mix layer of the full
// causal forward runs its WKV recurrence here.
//
// Function, per (batch b, head h), from a ZERO state, returning no state
// (as the TPU kernel, and as prefill, which throws the final state away):
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t
// with r, k, v, w (B, T, H, P) float32, w in (0, 1), u (H, P), the state S
// (P, P) keyed [key channel, value channel].  Over a chunk n of c steps
// (exact algebra, so c is this kernel's own, not the model's ssm_chunk):
//   seg = inclusive cumsum of log w;  esc = exclusive cumsum (per channel),
//         taken as seg of the step before, so that esc_i - seg_{i-1} is
//         exactly 0: seg_i - log w_i would round at seg's scale (|seg|
//         reaches 138 at w = 0.05), and under a strong decay the adjacent
//         pair's decay is the largest term
//   a_ij = sum_p r_ip k_jp exp(esc_ip - seg_jp)   (j < i: the PAIRWISE
//          exponent, always <= 0; the factored form (r e^esc)(k e^-seg)^T
//          overflows when decay is strong, e^-seg grows like w^-c)
//   a_ii = sum_p r_ip u_p k_ip                   (the bonus)
//   y_i  = sum_{j<=i} a_ij v_j + r~_i S_n,  r~ = r e^esc
//   S_{n+1} = diag(d_n) S_n + dS_n,  d_n = e^{seg_last},
//   dS_n = (k e^{seg_last - seg})^T v
// The logarithms and exponentials are taken in base 2 (log2f, exp2f), the
// same exponents in other units; IEEE float32 FMAs throughout (no fast
// math, no tensor cores: TF32 would keep about 1e-3, the check is 2e-4).
//
// Design.  Only the state's recurrence over chunks is sequential, and it is
// elementwise; everything else runs in parallel over chunks:
//   1. wkv6_chunk_kernel, grid (chunks, H, B), 256 threads, c = 32 steps:
//      loads the chunk's r, k, v, w once (steps past T as r = k = v = 0,
//      w = 1: they add nothing, so T < c and a ragged end need no other
//      path); scans log w with one warp per channel and one lane per step
//      (c is the warp's width); forms a_ij in 2 x 2 blocks of the lower
//      triangle with the pairwise exponent, never the TPU's (c, c, P) decay
//      tensor; writes, into a scratch buffer the wrapper allocates, the
//      intra-chunk y (bonus included), r~, d_n and dS_n, each padded to PP
//      channels (16, 32, 64 or 128) with zeros;
//   2. wkv6_scan_kernel, grid (PP^2 / 1024, H, B): S_{n+1} = diag(d_n) S_n
//      + dS_n, a float4 of the state per thread carried in registers
//      through all chunks with 16 chunks' loads in flight, S_n written over
//      dS_n.  The scratch is chunk-major, so the loads of one chunk from all
//      heads are one contiguous range;
//   3. wkv6_out_kernel, grid (chunks, H, B): y_i = (intra-chunk y)_i +
//      r~_i S_n.
// The products over a chunk are register-tiled (a float4 of one operand and
// a scalar or float4 of the other per 4 to 16 FMAs): at one shared-memory
// read per FMA, shared-memory bandwidth would be the limit.  A first design
// walked the chunks in one block per (head, 8 value channels), which also
// added r~_i S to y: each of those blocks read the whole r~ of its head, and
// on the card that walk was slower than the scan and the output kernel
// together, whatever the depth of its cp.async ring.
//
// What bounds it on this card.  The function reads r, k, v, w once and
// writes y once: 20 bytes per (step, channel), 210 MB for one rwkv6-3b layer
// at B = 1, T = 4096 (H = 40, P = 64), 63 us at 3.35 TB/s; its arithmetic is
// about 4 P^2 FLOP per step and head (2.7 GFLOP there, 41 us at 67 TFLOP/s
// float32), so bytes bound it.  This design moves more: the chunk kernel
// reads r, k, v, w (168 MB) and writes r~, the intra-chunk y (42 MB each)
// and dS (4 P^2 / c bytes per step and head: 84 MB); the scan reads and
// writes dS / S (168 MB); the output kernel reads r~, the intra-chunk y and
// S and writes y (210 MB): about 714 MB in all, 3.4x the function's bytes,
// 213 us at 3.35 TB/s.  The chunk kernel's pairwise exponentials, T c P / 2
// per head, are its largest arithmetic.
//
// C interface (bound with ctypes): wkv6_fwd(...) launches the kernels on
// the given stream, does not synchronise, and returns cudaGetLastError();
// wkv6_scratch_floats(...) gives the scratch buffer's size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;        // steps per chunk: one lane per step in the scan
constexpr int kThreads = 256;
constexpr int kPMax = 128;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;  // (H, P)
  float* y;
  // scratch, chunk-major (the scan's concurrent reads are contiguous)
  float* rt;   // (n_chunks, B, H, kC, PP): r e^esc
  float* yi;   // (n_chunks, B, H, kC, PP): the intra-chunk y
  float* ds;   // (n_chunks, B, H, PP, PP): dS_n, then S_n (scan kernel)
  float* dec;  // (n_chunks, B, H, PP): the chunks' decays e^seg_last
  long long sb, st, sh;     // element strides of r, k, v, w (P contiguous)
  long long ysb, yst, ysh;  // element strides of y
  int T, H, P, nch, BH;  // BH = B * H
};

int padded(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128; }

// ------------------------------------------------------------ chunk kernel

template <int PP>
constexpr size_t chunk_smem() {
  return ((size_t)kC * (PP + 4) + (size_t)kC * PP + 4 * (size_t)kC * (PP + 1) +
          kC * (kC + 1) + 2 * PP) * sizeof(float);
}

// The products over the chunk (the intra-chunk y, dS) are register-tiled:
// each thread reads a float4 of v and a float4 of k (or a column of a) per
// step j and does 8 or 16 FMAs with them; one shared-memory read per FMA
// would make shared-memory bandwidth this kernel's limit.
template <int PP>
__global__ void __launch_bounds__(kThreads) wkv6_chunk_kernel(Params p) {
  constexpr int LD = PP + 1;  // rows read across threads fall in 32 banks
  constexpr int LK = PP + 4;  // rows read as float4
  extern __shared__ float4 sm4[];
  float* kt = reinterpret_cast<float*>(sm4);  // kC x LK: k e^(seg_last - seg)
  float* vs = kt + kC * LK;       // kC x PP: v
  float* rs = vs + kC * PP;       // kC x LD: r
  float* ks = rs + kC * LD;       // kC x LD: k
  float* es = ks + kC * LD;       // kC x LD: esc
  float* gs = es + kC * LD;       // kC x LD: log2 w, then seg
  float* as = gs + kC * LD;       // kC x (kC + 1): a_ij, the bonus at i == j
  float* us = as + kC * (kC + 1); // PP: the bonus u of this head
  float* gl = us + PP;            // PP: seg_last

  const int tid = threadIdx.x, n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int P = p.P, t0 = n * kC, cl = min(kC, p.T - t0);
  const long long base = b * p.sb + h * p.sh;
  for (int idx = tid; idx < kC * PP; idx += kThreads) {
    const int i = idx / PP, c = idx % PP;
    float r = 0.f, k = 0.f, v = 0.f, lw = 0.f;
    if (i < cl && c < P) {
      const long long off = base + (t0 + i) * p.st + c;
      r = p.r[off];
      k = p.k[off];
      v = p.v[off];
      lw = log2f(p.w[off] + 1e-38f);
    }
    rs[i * LD + c] = r;
    ks[i * LD + c] = k;
    vs[i * PP + c] = v;
    gs[i * LD + c] = lw;
  }
  for (int c = tid; c < PP; c += kThreads) us[c] = c < P ? p.u[h * P + c] : 0.f;
  __syncthreads();

  // seg (inclusive) and esc (exclusive, the previous lane's seg): a warp
  // per channel, a lane per step
  const int warp = tid >> 5, lane = tid & 31;
  for (int c = warp; c < PP; c += kThreads / 32) {
    float x = gs[lane * LD + c];
#pragma unroll
    for (int o = 1; o < kC; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const float prev = __shfl_up_sync(0xffffffffu, x, 1);
    gs[lane * LD + c] = x;
    es[lane * LD + c] = lane == 0 ? 0.f : prev;
    if (lane == kC - 1) gl[c] = x;
  }
  __syncthreads();

  // a_ij in 2 x 2 blocks (I, J) of the lower triangle: jobs 0 .. 119 the
  // blocks J < I, jobs 120 .. 135 the diagonal blocks (bonus on i == j)
  for (int job = tid; job < 136; job += kThreads) {
    if (job < 120) {
      int I = (int)((1.f + sqrtf(1.f + 8.f * job)) * 0.5f);
      while (I * (I - 1) / 2 > job) --I;
      while ((I + 1) * I / 2 <= job) ++I;
      const int J = job - I * (I - 1) / 2;
      const int i0 = 2 * I, j0 = 2 * J;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
      for (int c = 0; c < PP; ++c) {
        const float r0 = rs[i0 * LD + c], r1 = rs[(i0 + 1) * LD + c];
        const float e0 = es[i0 * LD + c], e1 = es[(i0 + 1) * LD + c];
        const float k0 = ks[j0 * LD + c], k1 = ks[(j0 + 1) * LD + c];
        const float g0 = gs[j0 * LD + c], g1 = gs[(j0 + 1) * LD + c];
        a00 = fmaf(r0 * k0, exp2f(e0 - g0), a00);
        a01 = fmaf(r0 * k1, exp2f(e0 - g1), a01);
        a10 = fmaf(r1 * k0, exp2f(e1 - g0), a10);
        a11 = fmaf(r1 * k1, exp2f(e1 - g1), a11);
      }
      as[i0 * (kC + 1) + j0] = a00;
      as[i0 * (kC + 1) + j0 + 1] = a01;
      as[(i0 + 1) * (kC + 1) + j0] = a10;
      as[(i0 + 1) * (kC + 1) + j0 + 1] = a11;
    } else {
      const int i0 = 2 * (job - 120);
      float b0 = 0.f, b1 = 0.f, a10 = 0.f;
#pragma unroll 4
      for (int c = 0; c < PP; ++c) {
        const float r0 = rs[i0 * LD + c], r1 = rs[(i0 + 1) * LD + c];
        const float k0 = ks[i0 * LD + c], k1 = ks[(i0 + 1) * LD + c];
        b0 = fmaf(r0 * us[c], k0, b0);
        b1 = fmaf(r1 * us[c], k1, b1);
        a10 = fmaf(r1 * k0,
                   exp2f(es[(i0 + 1) * LD + c] - gs[i0 * LD + c]), a10);
      }
      as[i0 * (kC + 1) + i0] = b0;
      as[(i0 + 1) * (kC + 1) + i0 + 1] = b1;
      as[(i0 + 1) * (kC + 1) + i0] = a10;
    }
  }
  __syncthreads();

  // r~ = r e^esc to the scratch, k e^(seg_last - seg) into kt, and the
  // intra-chunk y_i = sum_{j <= i} a_ij v_j: a thread owns the rows i0 and
  // kC - 1 - i0 (33 terms in all, whatever i0) and four value channels
  constexpr int NQ = PP / 4;
  const long long chunk = (long long)n * p.BH + b * p.H + h;
  float* rt = p.rt + chunk * kC * PP;
  float* yi = p.yi + chunk * kC * PP;
  for (int idx = tid; idx < kC * PP; idx += kThreads) {
    const int i = idx / PP, c = idx % PP;
    rt[idx] = rs[i * LD + c] * exp2f(es[i * LD + c]);
    kt[i * LK + c] = ks[i * LD + c] * exp2f(gl[c] - gs[i * LD + c]);
  }
  for (int c = tid; c < PP; c += kThreads)
    p.dec[chunk * PP + c] = exp2f(gl[c]);
  for (int job = tid; job < (kC / 2) * NQ; job += kThreads) {
    const int i0 = job / NQ, i1 = kC - 1 - i0, qd = 4 * (job % NQ);
    float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j <= i1; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[j * PP + qd]);
      const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
      const float a1 = as[i1 * (kC + 1) + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) y1[e] = fmaf(a1, vj[e], y1[e]);
      if (j <= i0) {
        const float a0 = as[i0 * (kC + 1) + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) y0[e] = fmaf(a0, vj[e], y0[e]);
      }
    }
    *reinterpret_cast<float4*>(&yi[i0 * PP + qd]) =
        make_float4(y0[0], y0[1], y0[2], y0[3]);
    *reinterpret_cast<float4*>(&yi[i1 * PP + qd]) =
        make_float4(y1[0], y1[1], y1[2], y1[3]);
  }
  __syncthreads();

  // dS = (k e^(seg_last - seg))^T v: a thread owns 4 x 4 blocks (rows pd ..
  // pd + 3, columns qd .. qd + 3) of the (PP, PP) increment
  float* ds = p.ds + chunk * PP * PP;
  for (int job = tid; job < NQ * NQ; job += kThreads) {
    const int pd = 4 * (job / NQ), qd = 4 * (job % NQ);
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kC; ++j) {
      const float4 k4 = *reinterpret_cast<const float4*>(&kt[j * LK + pd]);
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[j * PP + qd]);
      const float kj[4] = {k4.x, k4.y, k4.z, k4.w};
      const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(kj[m], vj[q], acc[m][q]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      *reinterpret_cast<float4*>(&ds[(pd + m) * PP + qd]) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

// ------------------------------------------------------------- scan kernel

// S_{n+1} = diag(d_n) S_n + dS_n from S_0 = 0, in place: dS_n is replaced
// by S_n, the state entering chunk n.  Element-parallel: a thread carries
// a float4 of one head's state in registers through every chunk; no shared
// memory, no barrier.  Its few threads (B H P^2 / 4) walk the chunks in
// order, so the walk is bound by how many loads are in flight: each thread
// issues kU chunks' loads before it uses the first.
template <int PP>
__global__ void __launch_bounds__(kThreads) wkv6_scan_kernel(Params p) {
  constexpr int N4 = PP * PP / 4;  // float4s in a state
  constexpr int kU = 16;           // chunks loaded ahead
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= N4) return;
  const long long bh = (long long)blockIdx.z * p.H + blockIdx.y;
  float4* ds = reinterpret_cast<float4*>(p.ds + bh * PP * PP) + e;
  const float* dec = p.dec + bh * PP + (4 * e) / PP;
  const long long ds_step = (long long)p.BH * N4;
  const long long dec_step = (long long)p.BH * PP;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < p.nch; n0 += kU) {
    float4 x[kU];
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (n0 + u < p.nch) {
        x[u] = ds[(n0 + u) * ds_step];
        d[u] = dec[(n0 + u) * dec_step];
      }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (n0 + u < p.nch) {
        ds[(n0 + u) * ds_step] = S;
        S.x = fmaf(d[u], S.x, x[u].x);
        S.y = fmaf(d[u], S.y, x[u].y);
        S.z = fmaf(d[u], S.z, x[u].z);
        S.w = fmaf(d[u], S.w, x[u].w);
      }
  }
}

// ----------------------------------------------------------- output kernel

// y_i = (intra-chunk y)_i + r~_i S_n for the chunk's steps, parallel over
// chunks: r~ and S_n in shared memory; a thread owns the rows i0 and
// i0 + kC / 2 and four value channels (a float4 of S and two r~ per 8 FMAs).
template <int PP>
constexpr size_t out_smem() {
  return ((size_t)kC * (PP + 4) + (size_t)PP * PP) * sizeof(float);
}

template <int PP>
__global__ void __launch_bounds__(kThreads) wkv6_out_kernel(Params p) {
  constexpr int LK = PP + 4;  // r~ rows: 16-byte aligned, 4 rows, 4 banks
  constexpr int NQ = PP / 4;
  extern __shared__ float4 sm4[];
  float* rs = reinterpret_cast<float*>(sm4);  // kC x LK: r~
  float* Ss = rs + kC * LK;                   // PP x PP: S_n

  const int tid = threadIdx.x, n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long chunk = (long long)n * p.BH + b * p.H + h;
  const float4* rt = reinterpret_cast<const float4*>(p.rt + chunk * kC * PP);
  const float4* yi = reinterpret_cast<const float4*>(p.yi + chunk * kC * PP);
  const float4* S = reinterpret_cast<const float4*>(p.ds + chunk * PP * PP);
  for (int idx = tid; idx < kC * NQ; idx += kThreads)
    *reinterpret_cast<float4*>(&rs[(idx / NQ) * LK + 4 * (idx % NQ)]) =
        rt[idx];
  for (int idx = tid; idx < PP * NQ; idx += kThreads)
    reinterpret_cast<float4*>(Ss)[idx] = S[idx];
  __syncthreads();

  const int t0 = n * kC;
  float* yb = p.y + b * p.ysb + h * p.ysh;
  for (int job = tid; job < (kC / 2) * NQ; job += kThreads) {
    const int i0 = job / NQ, i1 = i0 + kC / 2, qd = 4 * (job % NQ);
    float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int c = 0; c < PP; ++c) {
      const float4 s4 = *reinterpret_cast<const float4*>(&Ss[c * PP + qd]);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
      const float r0 = rs[i0 * LK + c], r1 = rs[i1 * LK + c];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y0[e] = fmaf(r0, sc[e], y0[e]);
        y1[e] = fmaf(r1, sc[e], y1[e]);
      }
    }
    const float4 a0 = yi[i0 * NQ + qd / 4], a1 = yi[i1 * NQ + qd / 4];
    const float add0[4] = {a0.x, a0.y, a0.z, a0.w};
    const float add1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (qd + e >= p.P) break;
      if (t0 + i0 < p.T) yb[(t0 + i0) * p.yst + qd + e] = add0[e] + y0[e];
      if (t0 + i1 < p.T) yb[(t0 + i1) * p.yst + qd + e] = add1[e] + y1[e];
    }
  }
}

template <int PP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t c_smem = chunk_smem<PP>(), o_smem = out_smem<PP>();
  cudaError_t e;
  if (c_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(wkv6_chunk_kernel<PP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c_smem);
    if (e != cudaSuccess) return e;
  }
  if (o_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(wkv6_out_kernel<PP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)o_smem);
    if (e != cudaSuccess) return e;
  }
  wkv6_chunk_kernel<PP><<<dim3(p.nch, p.H, B), kThreads, c_smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int scan_blocks = (PP * PP / 4 + kThreads - 1) / kThreads;
  wkv6_scan_kernel<PP><<<dim3(scan_blocks, p.H, B), kThreads, 0, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv6_out_kernel<PP><<<dim3(p.nch, p.H, B), kThreads, o_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of the scratch buffer wkv6_fwd needs: r~, the intra-chunk y, the
// chunks' dS and d
long long wkv6_scratch_floats(int B, int T, int H, int P) {
  const long long PP = padded(P), nch = (T + kC - 1) / kC;
  return (long long)B * H * nch * (2 * kC * PP + PP * PP + PP);
}

int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, void* scratch, long long sb, long long st,
             long long sh, long long ysb, long long yst, long long ysh, int B,
             int T, int H, int P, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0 || P > kPMax || B > 65535 ||
      H > 65535 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int PP = padded(P);
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<float*>(y);
  p.T = T;
  p.H = H;
  p.P = P;
  p.nch = (T + kC - 1) / kC;
  p.BH = B * H;
  const long long per = (long long)B * H * p.nch;
  p.rt = static_cast<float*>(scratch);
  p.yi = p.rt + per * kC * PP;
  p.ds = p.yi + per * kC * PP;
  p.dec = p.ds + per * PP * PP;
  p.sb = sb;
  p.st = st;
  p.sh = sh;
  p.ysb = ysb;
  p.yst = yst;
  p.ysh = ysh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (PP) {
    case 16: return (int)launch<16>(p, B, s);
    case 32: return (int)launch<32>(p, B, s);
    case 64: return (int)launch<64>(p, B, s);
    default: return (int)launch<128>(p, B, s);
  }
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
