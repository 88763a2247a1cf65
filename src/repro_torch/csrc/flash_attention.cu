// Causal GQA flash-attention forward for Hopper (sm_90a), CUDA C++ on the
// CUDA cores: the float32 kernel.  bf16 inputs go to the tensor-core
// kernel of csrc/flash_attention_sm90.cu instead.
//
// Replaces the reference package's Pallas TPU kernel
//   K5  src/repro/kernels/flash_attention.py::_kernel  (launched by
//       flash_attention_pallas, wrapped by kernels/ops.py::flash_attention)
// and serves the port's prefill: every attention layer of a dense model's
// full causal forward (q_offset 0, no kv_len, S == T) comes here.
//
// Function.  o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h // G] * scale,
// masked) @ v[b, t, h // G], G = H / Hk, scale = 1/sqrt(dh).  With `causal`
// key t is visible to query s iff t <= s: the mask is aligned TOP-LEFT, as
// the TPU kernel's `k_pos <= q_pos` and the model's chunked attention at
// q_offset 0 (the reference's oracle ref.attention_ref aligns bottom-right;
// the two agree only when S == T).  Scores, the running max m, the running
// sum l and the accumulator are float32; masked scores are -1e30 (the TPU
// kernel's NEG_INF, not -inf, so exp(m_prev - m_new) stays finite); the
// output is acc / max(l, 1e-30).
//
// Design.  Grid = (query tiles, H, B); one block of 128 threads owns
// kBQ = 64 query rows of one head and walks the kv tiles of kBK = 64 rows
// in a loop (this loop replaces the TPU grid's sequential kv axis), and
// with `causal` stops at the tile holding the block's last query (the TPU
// kernel's pl.when skip above the diagonal).  Query tiles run heaviest
// first (reversed blockIdx.x) so the long causal rows start early.  Per kv
// tile: K and V are staged in shared memory as float32 (zero past T and
// past dh), once per block, read by every query row of the block; the
// query head h reads kv head h // G, so K/V is never copied per query head.
//   1. scores: each thread owns 4 query rows x 8 key columns (cols cg + 8j)
//      and reads Q and K rows as float4 (row stride DP + 4 floats, so the 8
//      threads of a quarter warp hit disjoint banks);
//   2. online softmax per row: max and sum over the 8 threads sharing the
//      rows by warp shuffles; rescale l and acc by exp(m_prev - m_new);
//   3. P (64 x 64) to shared memory, then acc += P V with each thread owning
//      4 rows x DP/8 output columns (float4 reads of V).
// Any S and T (ragged tails masked in the kernel), head dims up to 128
// (padded with zeros to DP = 32, 64 or 128: exact, padded q and k columns
// add 0 to every score and padded v columns are not stored).  Inputs and
// output are read through element strides (head dim contiguous), so the
// model's (B, S, H, dh) tensors and the (B, H, S, dh) layout of the
// reference's ops signature both go in without a copy.
//
// What bounds it on this card.  The work is 4 * B * H * dh FLOP per visible
// (query, key) pair: 2 for QK^T, 2 for PV; causal halves the pairs.  At
// llama3.2-1b's shape (H = 32, Hk = 8, dh = 64) the bytes are tiny next
// to it: q, k, v read once and o written once are 20 KB per token and
// layer in float32, against 4 * H * dh * (s + 1) FLOP for the token at
// position s, about 800 FLOP per byte at S = 4096.  So the operations bound
// it.  It does the products with plain IEEE float32 FMAs on the CUDA cores
// (67 TFLOP/s at most): a TF32 product on the tensor cores keeps about
// three decimal digits, and this path is held to 2e-5 against the float32
// plain version and to 1e-4 of max |logit| over a float32 prefill.
//
// C interface (bound with ctypes): flash_attention_fwd(...) launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLP = kBK + 4;   // row stride of the P tile (floats)
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, G, dh, causal;
  float scale;
};

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <int DP>
constexpr size_t smem_bytes() {
  // Q and K tiles (stride DP + 4), V tile (stride DP), P tile (stride kLP)
  return ((size_t)(kBQ + kBK) * (DP + 4) + (size_t)kBK * DP +
          (size_t)kBQ * kLP) * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LQ = DP + 4;
  constexpr int NC = DP / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // kBQ x LQ
  float* Ks = Qs + kBQ * LQ;                    // kBK x LQ
  float* Vs = Ks + kBK * LQ;                    // kBK x DP
  float* Ps = Vs + kBK * DP;                    // kBQ x kLP

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.G;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + hk * p.k_sh;
  const float* v = p.v + b * p.v_sb + hk * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, s = q0 + r;
    Qs[r * LQ + d] = (s < p.S && d < p.dh) ? q[s * p.q_ss + d] : 0.f;
  }

  const int rg = tid >> 3;  // query rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;   // key cols cg + 8j; output cols cg*4 + 32j + e
  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (p.T + kBK - 1) / kBK;
  if (p.causal) n_kv = min(n_kv, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP, t = k0 + r;
      const bool ok = t < p.T && d < p.dh;
      Ks[r * LQ + d] = ok ? k[t * p.k_ss + d] : 0.f;
      Vs[r * DP + d] = ok ? v[t * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // 1. scores of 4 rows x 8 cols, dot products over d in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * LQ + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb =
            *reinterpret_cast<const float4*>(&Ks[(cg + 8 * j) * LQ + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb.x, a);
          a = fmaf(qa[i].y, kb.y, a);
          a = fmaf(qa[i].z, kb.z, a);
          a = fmaf(qa[i].w, kb.w, a);
          s[i][j] = a;
        }
      }
    }

    // 2. mask, online softmax over the 8 threads that share the rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = k0 + cg + 8 * j;
        float x = s[i][j] * p.scale;
        if (kc >= p.T || (p.causal && kc > qr)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        Ps[(rg * 4 + i) * kLP + cg + 8 * j] = e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // 3. acc += P V over the tile's kBK keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(rg * 4 + i) * kLP + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float4 vb = *reinterpret_cast<const float4*>(
              &Vs[(kk + e) * DP + cg * 4 + 32 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = comp(pa[i], e);
            acc[i][j * 4 + 0] = fmaf(pw, vb.x, acc[i][j * 4 + 0]);
            acc[i][j * 4 + 1] = fmaf(pw, vb.y, acc[i][j * 4 + 1]);
            acc[i][j * 4 + 2] = fmaf(pw, vb.z, acc[i][j * 4 + 2]);
            acc[i][j * 4 + 3] = fmaf(pw, vb.w, acc[i][j * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + rg * 4 + i;
    if (s >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = cg * 4 + 32 * j + e;
        if (d < p.dh) o[s * p.o_ss + d] = acc[i][j * 4 + e] / den;
      }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<DP>;
  constexpr size_t smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t by_dp(const Params& p, int B, int H, cudaStream_t stream) {
  if (p.dh <= 32) return launch<32>(p, B, H, stream);
  if (p.dh <= 64) return launch<64>(p, B, H, stream);
  return launch<128>(p, B, H, stream);
}

}  // namespace

extern "C" {

// float32 q, k, v and o.  Strides in elements.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        int B, int S, int T, int H, int Hk, int dh,
                        float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      dh <= 0 || dh > 128 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.S = S;
  p.T = T;
  p.G = H / Hk;
  p.dh = dh;
  p.causal = causal ? 1 : 0;
  p.scale = scale;
  return (int)by_dp(p, B, H, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
