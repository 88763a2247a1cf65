// RWKV-6 ("Finch") chunked WKV forward for Hopper (sm_90a), CUDA C++ on the
// CUDA cores.
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
// (P, P) keyed [key channel, value channel].  Computed chunk by chunk as the
// TPU kernel computes it, over a chunk of c steps:
//   logw = log(w + 1e-38);  seg = inclusive cumsum of logw;  esc = seg - logw
//   a_ij = sum_p r_ip k_jp exp(esc_ip - seg_jp)   (j < i: the PAIRWISE
//          exponent, always <= 0; the factored form (r e^esc)(k e^-seg)^T
//          overflows when decay is strong, e^-seg grows like w^-c)
//   a_ii = sum_p r_ip u_p k_ip                   (the bonus)
//   y_i  = sum_{j<=i} a_ij v_j + (r_i * exp(esc_i)) S
//   S   <- S * exp(seg_last)[:, None] + (k * exp(seg_last - seg))^T v
// Plain IEEE float32 (logf, expf, fmaf; no fast math).
//
// Design.  One block of 256 threads per (b, h), grid B * H; the chunk loop
// runs inside the block (it replaces the TPU grid's sequential chunk axis)
// and the (P, P) float32 state lives in shared memory the whole time (16 KB
// at P = 64, 64 KB at P = 128).  Per chunk: the c x P tiles of r, k, v and
// log w are loaded (steps past T as r = k = v = 0, w = 1: such a step adds
// nothing to any output or to the state, so a ragged last chunk needs no
// other case); one thread per channel takes the two cumulative sums; one
// thread per (i, j) pair forms a_ij on the fly, never holding the TPU's
// (c, c, P) decay tensor; r and k are then rescaled in place by their
// decays; one thread per (i, value channel) forms y_i; one thread per state
// entry updates S.  Tiles read across threads by row are padded to P + 1
// floats per row, so 32 rows fall in 32 different banks.
//
// The chunk c = 32 is this kernel's own choice, fixed at compile time
// (chunking is exact algebra, so it need not be the model's ssm_chunk of
// 256 nor the TPU kernel's 64): the pairwise form costs T * c * P / 2
// exponentials per (b, h), which at c = 32 stays below the 2 * P^2 FMAs per
// step of the state read and update at P = 64, and the tiles plus the state
// take 62 KB of shared memory at P = 64 (153 KB at P = 128).
//
// What bounds it on this card.  The function reads r, k, v, w once and
// writes y once: 20 bytes per (step, channel), 210 MB for one rwkv6-3b layer
// at B = 1, T = 4096 (H = 40, P = 64), 63 us at 3.35 TB/s; its arithmetic is
// about 4 P^2 FLOP per step and head (2.7 GFLOP there, 41 us at 67 TFLOP/s
// float32), so bytes bound it.  This first version is far from that: one
// block per (b, h) gives only B * 40 blocks for the card's 132 SMs at
// rwkv6-3b's shape, and each block waits on its own loads at every chunk.
// Splitting the value channels of a head over several blocks (each keeps
// its slice of the state and recomputes the chunk's scores) and
// double-buffering the chunk loads is the first thing a later PR fixes.
//
// C interface (bound with ctypes): wkv6_fwd(...) launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;          // steps per chunk
constexpr int kThreads = 256;
constexpr int kPMax = 128;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory per block

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;  // (H, P)
  float* y;
  long long sb, st, sh;     // element strides of r, k, v, w (P contiguous)
  long long ysb, yst, ysh;  // element strides of y
  int T, H, P;
};

size_t smem_bytes(int P) {
  const size_t LD = P + 1;
  return (4 * kC * LD + (size_t)kC * P + (size_t)kC * (kC + 1) +
          (size_t)P * P + 2 * (size_t)P) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) wkv6_kernel(Params p) {
  extern __shared__ float sm[];
  const int P = p.P, LD = P + 1;
  float* rs = sm;                 // kC x LD: r, then r * exp(esc)
  float* ks = rs + kC * LD;       // kC x LD: k, then k * exp(seg_last - seg)
  float* es = ks + kC * LD;       // kC x LD: esc, the exclusive cumsum
  float* gs = es + kC * LD;       // kC x LD: log w, then seg (inclusive)
  float* vs = gs + kC * LD;       // kC x P
  float* as = vs + kC * P;        // kC x (kC + 1): a_ij, the bonus at i == j
  float* S = as + kC * (kC + 1);  // P x P state
  float* us = S + P * P;          // P: the bonus u of this head
  float* cd = us + P;             // P: exp(seg_last), the chunk's decay

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const long long base = b * p.sb + h * p.sh;
  const long long ybase = b * p.ysb + h * p.ysh;
  for (int i = tid; i < P * P; i += kThreads) S[i] = 0.f;
  for (int c = tid; c < P; c += kThreads) us[c] = p.u[h * P + c];

  for (int t0 = 0; t0 < p.T; t0 += kC) {
    const int cl = min(kC, p.T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < kC * P; idx += kThreads) {
      const int i = idx / P, c = idx % P;
      float r = 0.f, k = 0.f, v = 0.f, lw = 0.f;
      if (i < cl) {
        const long long off = base + (t0 + i) * p.st + c;
        r = p.r[off];
        k = p.k[off];
        v = p.v[off];
        lw = logf(p.w[off] + 1e-38f);
      }
      rs[i * LD + c] = r;
      ks[i * LD + c] = k;
      vs[i * P + c] = v;
      gs[i * LD + c] = lw;
    }
    __syncthreads();

    // inclusive (seg) and exclusive (esc) cumulative log-decay per channel
    for (int c = tid; c < P; c += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < kC; ++i) {
        const float lw = gs[i * LD + c];
        acc += lw;
        gs[i * LD + c] = acc;
        es[i * LD + c] = acc - lw;
      }
      cd[c] = expf(acc);
    }
    __syncthreads();

    // intra-chunk scores with the pairwise exponent; the bonus on i == j
    for (int idx = tid; idx < kC * kC; idx += kThreads) {
      const int i = idx / kC, j = idx % kC;
      float a = 0.f;
      if (j < i) {
        for (int c = 0; c < P; ++c)
          a = fmaf(rs[i * LD + c] * ks[j * LD + c],
                   expf(es[i * LD + c] - gs[j * LD + c]), a);
      } else if (j == i) {
        for (int c = 0; c < P; ++c)
          a = fmaf(rs[i * LD + c] * us[c], ks[i * LD + c], a);
      }
      as[i * (kC + 1) + j] = a;
    }
    __syncthreads();

    // r_i * exp(esc_i) (reads the state) and k_j * exp(seg_last - seg_j)
    // (feeds it), in place
    for (int idx = tid; idx < kC * P; idx += kThreads) {
      const int i = idx / P, c = idx % P;
      rs[i * LD + c] *= expf(es[i * LD + c]);
      ks[i * LD + c] *= expf(gs[(kC - 1) * LD + c] - gs[i * LD + c]);
    }
    __syncthreads();

    // y_i = sum_{j <= i} a_ij v_j + (r_i e^esc_i) S
    for (int idx = tid; idx < cl * P; idx += kThreads) {
      const int i = idx / P, q = idx % P;
      float yi = 0.f;
      for (int j = 0; j <= i; ++j)
        yi = fmaf(as[i * (kC + 1) + j], vs[j * P + q], yi);
      float yo = 0.f;
      for (int c = 0; c < P; ++c) yo = fmaf(rs[i * LD + c], S[c * P + q], yo);
      p.y[ybase + (t0 + i) * p.yst + q] = yi + yo;
    }
    __syncthreads();  // every reader of S is done

    // S <- S * exp(seg_last) + (k e^(seg_last - seg))^T v
    for (int idx = tid; idx < P * P; idx += kThreads) {
      const int c = idx / P, q = idx % P;
      float s = S[idx] * cd[c];
      for (int j = 0; j < kC; ++j) s = fmaf(ks[j * LD + c], vs[j * P + q], s);
      S[idx] = s;
    }
  }
}

}  // namespace

extern "C" {

int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* y, long long sb, long long st, long long sh,
             long long ysb, long long yst, long long ysh, int B, int T, int H,
             int P, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || P <= 0 || P > kPMax ||
      (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<float*>(y);
  p.sb = sb;
  p.st = st;
  p.sh = sh;
  p.ysb = ysb;
  p.yst = yst;
  p.ysh = ysh;
  p.T = T;
  p.H = H;
  p.P = P;
  const size_t smem = smem_bytes(P);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_kernel<<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
