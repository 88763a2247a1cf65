// GQA flash-attention forward for a few query rows (bf16 in and out,
// float32 arithmetic on the CUDA cores), the route of K5's bf16 calls whose
// query length S is at most the wrapper's S_SHORT: a decode step's
// cross-attention (seamless-m4t-large-v2: one query over 8 cached frames),
// a short encoder call.
//
// Replaces, for those calls, the reference package's Pallas TPU kernel
//   K5  src/repro/kernels/flash_attention.py::_kernel  (launched by
//       flash_attention_pallas, wrapped by kernels/ops.py::flash_attention);
// longer bf16 calls keep csrc/flash_attention_sm90.cu, float32 calls
// csrc/flash_attention.cu.
//
// Function (as the other two K5 kernels): o[b, s, h] = softmax_t(q[b, s, h]
// . k[b, t, h // G] * scale, masked) @ v[b, t, h // G], scale = 1/sqrt(dh),
// q and k dh wide, v and o dv wide (dv <= dh <= 128); with `causal` key t
// is visible to query s iff t <= s (top-left); masked scores are -1e30 (in
// the log2 units below); the output is acc / max(l, 1e-30) in bf16.  Every
// product is float32 (q and k, P and v), so P is never rounded to bf16:
// this route sits closer to the plain version than the tensor-core kernel.
//
// Why a kernel of its own.  With S of 1 the 128-row tensor-core kernel
// spends its launch on rows it never uses: a 64-row wgmma M for one live
// row, TMA boxes of 128 rows zero-filled past row 1 and past key 8, a
// second consumer warpgroup with no live row, and 230 KB of shared memory
// a block.  The work of such a call is its bytes (q, k, v read once, o
// written once: 0.044 us of HBM for the decode call above), so what bounds
// it is latency: the launch, then one round trip to memory and the
// reductions after it.  The design keeps that chain short: no shared-memory
// staging of K and V, no barrier before the first product, and the keys of
// a long cache split over blocks so that each block walks a few steps.
//
// Design.  One block of 128 threads per (key split, row tile, b and kv
// head).  The block holds up to RB (1 or 2) of the kv head's G S query
// rows (row r = s G + g, query head hk G + g), so K and V are read once a
// row tile, not G times.  A key belongs to a group of L lanes (L = 8 where
// dh <= 64, else 16), lane j of the group owning the 8 columns 8j .. 8j + 7
// of q, k, v and o: it loads them straight from memory into registers (one
// 16-byte load a row where bases, strides and widths allow, element loads
// otherwise, e.g. dh 100 with its 200-byte rows), and holds them as bf16
// until it uses them; the next step's loads are issued before this step
// computes (two register buffers in turn), and the first step's before q's.
// q sits in registers, times scale * log2 e, so scores come out in log2
// units and p = exp2(s - m).  A step gives each group KPG = 4 consecutive
// keys: the lanes' partial dot products sum over the group by xor
// shuffles, and the group runs its own online softmax over its keys (m and
// l the same in its lanes, o its columns).  After the last step the groups
// of a warp merge by shuffles and the four warps through shared memory, by
// the split softmax's rule: M = max m, o = sum o 2^(m - M) / sum l 2^(m -
// M).  Two rows a block hold 168 registers with both buffers; four held
// too many for enough blocks an SM, so more rows take more row tiles.
// Long T: the wrapper's plan splits the keys so that the grid holds about
// four blocks an SM; each block writes its float32 (o, m, l) to scratch
// the wrapper allocates, takes an integer ticket, and the last block of a
// (b, kv head, row tile) merges the splits in split order by the same rule
// (the same bits whichever block comes last) and sets the ticket back to 0
// (the wrapper keeps the tickets per device, so a call needs no fill).
// With `causal` a block's keys end at its last row's s + 1: a causal call
// sees at most S keys and the plan never splits it.
//
// C interface (bound with ctypes): flash_attention_short_fwd(...) launches
// on the given stream, does not synchronise and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct ShortParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* part_o;    // (B Hk, row tiles, splits, RB, dv), splits > 1 only
  float* part_ml;   // (B Hk, row tiles, splits, RB, 2)
  int* tickets;     // (B Hk, row tiles), 0 on entry and on exit
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, Hk, G, dh, dv, causal;
  int vec16;     // every row of q, k and v can be read as 16-byte pieces
  int n_split, keys_per_split, n_rt;
  float scale_log2;  // scale * log2 e
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Columns c0 .. c0 + 7 of a row as 8 bf16 in a uint4, zero at or past
// `width` or where the row is not `valid`: one 16-byte load where the rows
// allow it, element loads otherwise.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int c0,
                                       int width, bool valid, bool vec16) {
  if (vec16)
    return valid && c0 < width
               ? __ldg(reinterpret_cast<const uint4*>(row + c0))
               : make_uint4(0, 0, 0, 0);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 2 * i;
    const uint32_t lo = valid && c < width
                            ? __bfloat16_as_ushort(row[c]) : 0u;
    const uint32_t hi = valid && c + 1 < width
                            ? __bfloat16_as_ushort(row[c + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void to_float(float (&x)[8], uint4 raw) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(const ShortParams& p, int b, int hk,
                                          int ri, int col, float x) {
  const int s = ri / p.G, h = hk * p.G + ri % p.G;
  p.o[b * p.o_sb + s * p.o_ss + h * p.o_sh + col] = __float2bfloat16(x);
}

// ---------------------------------------------------------------- kernel

template <int RB, int L>
__global__ void __launch_bounds__(kThreads)
    flash_short_kernel(const ShortParams p) {
  constexpr int KPG = 4;                      // keys a group a step
  constexpr int kGroups = kThreads / L;       // groups a block
  constexpr int kStep = kGroups * KPG;        // keys a block a step
  constexpr int kCols = 8 * L;                // output columns a group
  __shared__ float sO[4][RB][kCols];
  __shared__ float sM[4][RB], sL[4][RB];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = tid / L, c0 = 8 * (tid % L);
  const int split = blockIdx.x, rt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.Hk, hk = bh - b * p.Hk;
  const int R = p.G * p.S, row0 = rt * RB, nrows = min(RB, R - row0);
  // the block's keys [t_lo, t_hi); causal: none past its last row's s
  const int t_lo = split * p.keys_per_split;
  int t_hi = min(p.T, t_lo + p.keys_per_split);
  if (p.causal) t_hi = min(t_hi, (row0 + nrows - 1) / p.G + 1);
  const bool vec16 = p.vec16 != 0;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  // a step's K and V (this lane's columns of its group's KPG keys), raw
  auto load = [&](uint4 (&kr)[KPG], uint4 (&vr)[KPG], int t0) {
    const int tg = t0 + grp * KPG;
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      const bool ok = tg + j < t_hi;
      const long long t = ok ? tg + j : 0;
      kr[j] = load8(kb + t * p.k_ss, c0, p.dh, ok, vec16);
      vr[j] = load8(vb + t * p.v_ss, c0, p.dv, ok, vec16);
    }
  };
  // the first step's loads go out before q's
  uint4 ka[KPG], va[KPG], kn[KPG], vn[KPG];
  load(ka, va, t_lo);

  // this lane's 8 columns of the block's q rows, in log2 units
  float q[RB][8];
  int srow[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int ri = row0 + r;
    srow[r] = ri / p.G;
    const __nv_bfloat16* qrow =
        p.q + b * p.q_sb + srow[r] * p.q_ss + (hk * p.G + ri % p.G) * p.q_sh;
    to_float(q[r], load8(qrow, c0, p.dh, r < nrows, vec16));
#pragma unroll
    for (int i = 0; i < 8; ++i) q[r][i] *= p.scale_log2;
  }

  float o[RB][8], m[RB], l[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[r][i] = 0.f;
  }

  // one step on the keys tg .. tg + KPG - 1 held in (kr, vr): scores
  // summed over the group's lanes, then the group's online softmax
  auto step = [&](const uint4 (&kr)[KPG], const uint4 (&vr)[KPG], int t0) {
    const int tg = t0 + grp * KPG;
    float s[RB][KPG];
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      float kf[8];
      to_float(kf, kr[j]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(q[r][i], kf[i], acc);
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        const int t = tg + j;
        s[r][j] = t < t_hi && !(p.causal && t > srow[r]) ? acc : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int j = 1; j < KPG; ++j) mx = fmaxf(mx, s[r][j]);
      const float mn = fmaxf(m[r], mx);
      const float a = ex2(m[r] - mn);
      m[r] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPG; ++j) {
        s[r][j] = ex2(s[r][j] - mn);
        ps += s[r][j];
      }
      l[r] = l[r] * a + ps;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[r][i] *= a;
    }
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      float vf[8];
      to_float(vf, vr[j]);
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) o[r][i] = fmaf(s[r][j], vf[i], o[r][i]);
    }
  };

  // two register buffers in turn: the next step's loads are in flight
  // while this step computes
  for (int t0 = t_lo; t0 < t_hi; t0 += 2 * kStep) {
    const int t1 = t0 + kStep;
    if (t1 < t_hi) load(kn, vn, t1);
    step(ka, va, t0);
    if (t1 >= t_hi) break;
    if (t1 + kStep < t_hi) load(ka, va, t1 + kStep);
    step(kn, vn, t1);
  }

  // the groups of a warp merge by shuffles (lane j + L holds the columns
  // of lane j for another group's keys)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float M = fmaxf(m[r], m2);
      const float e1 = ex2(m[r] - M), e2 = ex2(m2 - M);
      l[r] = l[r] * e1 + l2 * e2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float o2 = __shfl_xor_sync(0xffffffffu, o[r][i], off);
        o[r][i] = o[r][i] * e1 + o2 * e2;
      }
      m[r] = M;
    }
  }
  // then the four warps through shared memory
  if (lane < L) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sO[warp][r][c0 + i] = o[r][i];
      if (lane == 0) {
        sM[warp][r] = m[r];
        sL[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  const bool one = p.n_split == 1;
  const long long part = ((long long)(bh * p.n_rt + rt) * p.n_split + split) *
                         RB;   // this block's first scratch row
  for (int idx = tid; idx < nrows * p.dv; idx += kThreads) {
    const int r = idx / p.dv, col = idx - r * p.dv;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, sM[w][r]);
    float O = 0.f, Lr = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float e = ex2(sM[w][r] - M);
      O = fmaf(sO[w][r][col], e, O);
      Lr = fmaf(sL[w][r], e, Lr);
    }
    if (one) {
      store_out(p, b, hk, row0 + r, col, O / fmaxf(Lr, 1e-30f));
    } else {
      p.part_o[(part + r) * p.dv + col] = O;
      if (col == 0) {
        p.part_ml[2 * (part + r)] = M;
        p.part_ml[2 * (part + r) + 1] = Lr;
      }
    }
  }
  if (one) return;

  // the last block of this (b, kv head, row tile) merges the splits
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + bh * p.n_rt + rt;
  if (tid == 0) s_last = atomicAdd(ticket, 1) == p.n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long first = (long long)(bh * p.n_rt + rt) * p.n_split * RB;
  for (int idx = tid; idx < nrows * p.dv; idx += kThreads) {
    const int r = idx / p.dv, col = idx - r * p.dv;
    float M = kNegInf;
    for (int sp = 0; sp < p.n_split; ++sp)
      M = fmaxf(M, __ldcg(p.part_ml + 2 * (first + sp * RB + r)));
    float O = 0.f, Lr = 0.f;
    for (int sp = 0; sp < p.n_split; ++sp) {
      const long long row = first + sp * RB + r;
      const float e = ex2(__ldcg(p.part_ml + 2 * row) - M);
      O = fmaf(__ldcg(p.part_o + row * p.dv + col), e, O);
      Lr = fmaf(__ldcg(p.part_ml + 2 * row + 1), e, Lr);
    }
    store_out(p, b, hk, row0 + r, col, O / fmaxf(Lr, 1e-30f));
  }
  if (tid == 0) *ticket = 0;   // every block of the call has taken its own
}

// ---------------------------------------------------------------- host

template <int RB, int L>
cudaError_t launch(const ShortParams& p, dim3 grid, cudaStream_t stream) {
  flash_short_kernel<RB, L><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_rb(int rb, const ShortParams& p, dim3 grid,
                      cudaStream_t st) {
  switch (rb) {
    case 1: return launch<1, L>(p, grid, st);
    case 2: return launch<2, L>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(long long x) { return x % 16 == 0; }

}  // namespace

extern "C" {

// bf16 q, k (dh wide), v and o (dv wide); strides in elements.  rb, n_split
// and keys_per_split are the wrapper's plan (kernels/flash_attention.py::
// short_plan); with n_split > 1, part_o, part_ml and tickets are its
// scratch (tickets 0, and left 0), else they may be null.
int flash_attention_short_fwd(const void* q, const void* k, const void* v,
                              void* o, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, long long o_sb, long long o_ss,
                              long long o_sh, int B, int S, int T, int H,
                              int Hk, int dh, int dv, float scale, int causal,
                              int rb, int n_split, int keys_per_split,
                              void* part_o, void* part_ml, void* tickets,
                              void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 ||
      dh <= 0 || dh > 128 || dv <= 0 || dv > dh || n_split <= 0 ||
      keys_per_split <= 0 || (long long)n_split * keys_per_split < T ||
      B * (long long)Hk > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (part_o == nullptr || part_ml == nullptr ||
                      tickets == nullptr || causal))
    return (int)cudaErrorInvalidValue;
  ShortParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.tickets = static_cast<int*>(tickets);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.S = S;
  p.T = T;
  p.Hk = Hk;
  p.G = H / Hk;
  p.dh = dh;
  p.dv = dv;
  p.causal = causal ? 1 : 0;
  // 16-byte pieces: aligned bases, every stride of a dimension stepped and
  // both widths multiples of 8 elements
  p.vec16 = aligned16((long long)reinterpret_cast<uintptr_t>(q)) &&
            aligned16((long long)reinterpret_cast<uintptr_t>(k)) &&
            aligned16((long long)reinterpret_cast<uintptr_t>(v)) &&
            dh % 8 == 0 && dv % 8 == 0 &&
            (S == 1 || aligned16(2 * q_ss)) &&
            (H == 1 || aligned16(2 * q_sh)) && (B == 1 || aligned16(2 * q_sb)) &&
            (T == 1 || (aligned16(2 * k_ss) && aligned16(2 * v_ss))) &&
            (Hk == 1 || (aligned16(2 * k_sh) && aligned16(2 * v_sh))) &&
            (B == 1 || (aligned16(2 * k_sb) && aligned16(2 * v_sb)));
  p.n_split = n_split;
  p.keys_per_split = keys_per_split;
  const int R = p.G * S;
  p.n_rt = (R + rb - 1) / rb;
  p.scale_log2 = scale * kLog2e;
  if (p.n_rt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_split, p.n_rt, B * Hk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dh > 64 ? launch_rb<16>(rb, p, grid, st)
                       : launch_rb<8>(rb, p, grid, st));
}

const char* flash_attention_short_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
