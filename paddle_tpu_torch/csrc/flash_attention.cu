// Flash attention for Hopper (sm_90a): forward (K1), backward dQ (K2) and
// backward dK/dV (K3), with a plain C interface loaded through ctypes by
// paddle_tpu_torch/ops/kernels.py. Python wrappers, checks and the plain
// PyTorch versions live in paddle_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels of paddle_tpu/ops/flash_attention.py:
//   K1 flash_fwd_kernel      <- _make_flash_kernel / _flash_fwd_pallas (:136-245)
//   K2 flash_bwd_dq_kernel   <- _make_flash_bwd_dq_kernel (:288-319, call :401-409)
//   K3 flash_bwd_dkv_kernel  <- _make_flash_bwd_dkv_kernel (:322-362, call :415-427)
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, S, H, D] read and written through
// their batch / sequence / head strides (the head dim is contiguous), so the
// TPU wrapper's head-fold transposes and padding copies are gone. lse and
// delta are [B, H, Sq] fp32: one value a row, not the TPU's 128-lane
// replication (a Mosaic tiling rule, not part of the result).
//
// Design (simple first; wgmma/TMA are later work):
//   * 64x64 tiles. A block of 256 threads (a 16x16 thread grid) owns one
//     (b*h, 64-row tile) and loops over the other sequence inside the block.
//     That loop replaces the TPU grid's sequential last axis, whose sums were
//     carried across grid steps in VMEM scratch: CUDA blocks run in no order.
//   * Tiles are staged in dynamic shared memory as fp32, rows padded to D+1
//     floats so column walks hit 32 distinct banks. For D=128 the tiles pass
//     the 48 KB static limit, hence cudaFuncSetAttribute below.
//   * Every dot product is full fp32 on the CUDA cores (no TF32, no tensor
//     cores): bf16 inputs are widened on load. Outputs round once to the
//     input type. Accumulation is fp32 throughout.
//   * Each thread keeps a 4 x (D/16) accumulator tile in registers; the
//     online-softmax row state (m, l) lives in shared memory.
//   * No atomics: K2 owns dQ rows, K3 owns dK/dV rows. K2's prologue writes
//     delta = rowsum(dO * O), which K3 (launched after it on the same stream)
//     reads.
// What bounds them on an H100: at BERT-base (B16 S128 H12 D64, fp32) the
// dot products at the 67 TFLOP/s fp32 rate take 1.5-2x longer than moving
// the bytes at 3.35 TB/s (K1 12.0 us against 7.5 us), so operations bound
// all three; chip_smoke.py computes both bounds from each call's shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;          // rows of a q tile and of a k tile
constexpr int NT = 256;           // threads a block: ty = t / 16, tx = t % 16
constexpr int SP = TILE + 1;      // padded row of a [TILE][TILE] score tile
constexpr float NEG_INF = -1e30f; // the reference's lse of an empty row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {   // element strides of a [B, S, H, D] tensor; stride of D is 1
  int64_t b, s, h;
};

struct Shape {
  int H, Sq, Sk;
  float scale;
  int causal;
};

// Rows [row0, row0 + TILE) of head (b, h) into a [TILE][D+1] fp32 tile;
// rows at or past `len` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st, int b, int h,
                                          int row0, int len) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    const int s = row0 + r;
    float x = 0.f;
    if (s < len) x = to_f(src[b * st.b + s * st.s + h * st.h + d]);
    dst[r * (D + 1) + d] = x;
  }
}

// ---------------------------------------------------------------------------
// K1: o = softmax(mask(q k^T * scale)) v and lse = m + log l, online softmax.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq_st, Strides sk_st,
                 Shape sh) {
  constexpr int P = D + 1;
  constexpr int RD = D / 16;   // accumulator columns a thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + TILE * P;
  float* sV = sK + TILE * P;
  float* sS = sV + TILE * P;   // scores, then probabilities
  float* sM = sS + TILE * SP;  // running row max
  float* sL = sM + TILE;       // running row sum
  float* sA = sL + TILE;       // this step's rescale factor

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.y * TILE;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;

  load_tile<T, D>(sQ, q, sq_st, b, h, q0, sh.Sq);
  if (t < TILE) {
    sM[t] = -INFINITY;
    sL[t] = 0.f;
  }
  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const int n_k = (sh.Sk + TILE - 1) / TILE;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * TILE;
    // causal: a k tile that starts after this q tile's last row is skipped
    if (sh.causal && k0 > q0 + TILE - 1) break;
    load_tile<T, D>(sK, k, sk_st, b, h, k0, sh.Sk);
    load_tile<T, D>(sV, v, sk_st, b, h, k0, sh.Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = kpos < sh.Sk && (!sh.causal || kpos <= q0 + r);
        sS[r * SP + c] = ok ? s[i][j] * sh.scale : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: four consecutive lanes own one row
      const int r = t / 4, part = t % 4;
      float mx = -INFINITY;
      for (int m = 0; m < TILE / 4; ++m) mx = fmaxf(mx, sS[r * SP + part + 4 * m]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int m = 0; m < TILE / 4; ++m) {
        const int idx = r * SP + part + 4 * m;
        const float p = (m_new == -INFINITY) ? 0.f : expf(sS[idx] - m_new);
        sS[idx] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < TILE; ++kk) {
      float pv[4], vv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = sV[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r;
    if (s >= sh.Sq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = tx + 16 * j;
      o[b * sq_st.b + s * sq_st.s + h * sq_st.h + d] = from_f<T>(acc[i][j] * inv);
    }
  }
  if (t < TILE && q0 + t < sh.Sq) {
    const float l = sL[t];
    lse[(int64_t)bh * sh.Sq + q0 + t] = l > 0.f ? sM[t] + logf(l) : NEG_INF;
  }
}

// Shared by K2 and K3: for the thread's 4x4 cells of the (q tile, k tile)
// pair, P = exp(S - lse) under the ragged and causal masks and
// dS = P * (dO v^T - delta) * scale (the reference's _recompute_p_ds).
template <int D>
__device__ __forceinline__ void recompute_p_ds(const float* sQ, const float* sDO, const float* sK,
                                               const float* sV, const float* sLse,
                                               const float* sDelta, int q0, int k0,
                                               const Shape& sh, float p[4][4], float ds[4][4]) {
  constexpr int P = D + 1;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * P + d];
      dov[i] = sDO[(ty + 16 * i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * P + d];
      vv[j] = sV[(tx + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
    const float l = sLse[r], dl = sDelta[r];
    const bool row_ok = qpos < sh.Sq && l > NEG_INF * 0.5f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool ok = row_ok && kpos < sh.Sk && (!sh.causal || qpos >= kpos);
      const float pr = ok ? expf(s[i][j] * sh.scale - l) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (dp[i][j] - dl) * sh.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ = sum_k dS k, one block a (b*h, q tile); the prologue writes delta.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, Strides sq_st, Strides sk_st, Shape sh) {
  constexpr int P = D + 1;
  constexpr int RD = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + TILE * P;
  float* sK = sDO + TILE * P;
  float* sV = sK + TILE * P;
  float* sDS = sV + TILE * P;
  float* sLse = sDS + TILE * SP;
  float* sDelta = sLse + TILE;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.y * TILE;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;

  load_tile<T, D>(sQ, q, sq_st, b, h, q0, sh.Sq);
  load_tile<T, D>(sDO, dout, sq_st, b, h, q0, sh.Sq);
  __syncthreads();
  {  // delta = rowsum(dO * O), four consecutive lanes a row
    const int r = t / 4, part = t % 4;
    const int s = q0 + r;
    float sum = 0.f;
    if (s < sh.Sq) {
      const T* orow = o + b * sq_st.b + s * sq_st.s + h * sq_st.h;
      for (int d = part; d < D; d += 4) sum = fmaf(sDO[r * P + d], to_f(orow[d]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      sDelta[r] = sum;
      sLse[r] = s < sh.Sq ? lse[(int64_t)bh * sh.Sq + s] : NEG_INF;
      if (s < sh.Sq) delta[(int64_t)bh * sh.Sq + s] = sum;
    }
  }

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const int n_k = (sh.Sk + TILE - 1) / TILE;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * TILE;
    if (sh.causal && k0 > q0 + TILE - 1) break;
    load_tile<T, D>(sK, k, sk_st, b, h, k0, sh.Sk);
    load_tile<T, D>(sV, v, sk_st, b, h, k0, sh.Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    recompute_p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, k0, sh, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sDS[(ty + 16 * i) * SP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    for (int kk = 0; kk < TILE; ++kk) {
      float dv_[4], kv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = sDS[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) kv[j] = sK[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(dv_[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= sh.Sq) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      dq[b * sq_st.b + s * sq_st.s + h * sq_st.h + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3: dV = sum_q P^T dO and dK = sum_q dS^T q, one block a (b*h, k tile).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq_st, Strides sk_st, Shape sh) {
  constexpr int P = D + 1;
  constexpr int RD = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TILE * P;
  float* sQ = sV + TILE * P;
  float* sDO = sQ + TILE * P;
  float* sP = sDO + TILE * P;
  float* sDS = sP + TILE * SP;
  float* sLse = sDS + TILE * SP;
  float* sDelta = sLse + TILE;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.y * TILE;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;

  load_tile<T, D>(sK, k, sk_st, b, h, k0, sh.Sk);
  load_tile<T, D>(sV, v, sk_st, b, h, k0, sh.Sk);

  float dk_acc[4][RD], dv_acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int n_q = (sh.Sq + TILE - 1) / TILE;
  // causal: a q tile whose last row lies before this k tile sees none of it
  const int qt0 = sh.causal ? k0 / TILE : 0;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * TILE;
    load_tile<T, D>(sQ, q, sq_st, b, h, q0, sh.Sq);
    load_tile<T, D>(sDO, dout, sq_st, b, h, q0, sh.Sq);
    if (t < TILE) {
      const int s = q0 + t;
      sLse[t] = s < sh.Sq ? lse[(int64_t)bh * sh.Sq + s] : NEG_INF;
      sDelta[t] = s < sh.Sq ? delta[(int64_t)bh * sh.Sq + s] : 0.f;
    }
    __syncthreads();
    float p[4][4], ds[4][4];
    recompute_p_ds<D>(sQ, sDO, sK, sV, sLse, sDelta, q0, k0, sh, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(ty + 16 * i) * SP + tx + 16 * j] = p[i][j];
        sDS[(ty + 16 * i) * SP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // this thread's k rows are ty + 16 i, its head-dim columns tx + 16 j
    for (int qq = 0; qq < TILE; ++qq) {
      float pv[4], dsv[4], dov[RD], qv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[qq * SP + ty + 16 * i];
        dsv[i] = sDS[qq * SP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        dov[j] = sDO[qq * P + tx + 16 * j];
        qv[j] = sQ[qq * P + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= sh.Sk) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int64_t off = b * sk_st.b + s * sk_st.s + h * sk_st.h + tx + 16 * j;
      dk[off] = from_f<T>(dk_acc[i][j]);
      dv[off] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * TILE * (D + 1) + TILE * SP + 3 * TILE);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * SP + 2 * TILE);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * SP + 2 * TILE);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *delta_in;
  void *out_o, *out_a, *out_b;
  float *lse_out, *delta_out;
  int64_t B;
  Strides sq_st, sk_st;
  Shape sh;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sq + TILE - 1) / TILE));
  flash_fwd_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out_o, a.lse_out, a.sq_st, a.sk_st,
      a.sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sq + TILE - 1) / TILE));
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.dout, a.lse,
      a.delta_out, (T*)a.out_o, a.sq_st, a.sk_st, a.sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sk + TILE - 1) / TILE));
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta_in,
      (T*)a.out_a, (T*)a.out_b, a.sq_st, a.sk_st, a.sh);
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; head dim 64 or 128.
template <template <typename, int> class L>
int dispatch(const Args& a, int dtype, int64_t D) {
  if (dtype == 0 && D == 64) return (int)L<float, 64>::run(a);
  if (dtype == 0 && D == 128) return (int)L<float, 128>::run(a);
  if (dtype == 1 && D == 64) return (int)L<__nv_bfloat16, 64>::run(a);
  if (dtype == 1 && D == 128) return (int)L<__nv_bfloat16, 128>::run(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D> struct Fwd { static cudaError_t run(const Args& a) { return launch_fwd<T, D>(a); } };
template <typename T, int D> struct Dq { static cudaError_t run(const Args& a) { return launch_dq<T, D>(a); } };
template <typename T, int D> struct Dkv { static cudaError_t run(const Args& a) { return launch_dkv<T, D>(a); } };

Args make_args(int64_t B, int64_t H, int64_t Sq, int64_t Sk, int64_t qsb, int64_t qss,
               int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, float scale, int causal,
               void* stream) {
  Args a = {};
  a.B = B;
  a.sq_st = {qsb, qss, qsh};
  a.sk_st = {ksb, kss, ksh};
  a.sh = {(int)H, (int)Sq, (int)Sk, scale, causal};
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int ptt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
                  int64_t H, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb, int64_t qss,
                  int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, float scale, int causal,
                  int dtype, void* stream) {
  Args a = make_args(B, H, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, scale, causal, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out_o = o;
  a.lse_out = lse;
  return dispatch<Fwd>(a, dtype, D);
}

int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, int64_t B,
                     int64_t H, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb, int64_t qss,
                     int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, float scale,
                     int causal, int dtype, void* stream) {
  Args a = make_args(B, H, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, scale, causal, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta_out = delta;
  a.out_o = dq;
  return dispatch<Dq>(a, dtype, D);
}

int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int64_t B,
                      int64_t H, int64_t Sq, int64_t Sk, int64_t D, int64_t qsb, int64_t qss,
                      int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh, float scale,
                      int causal, int dtype, void* stream) {
  Args a = make_args(B, H, Sq, Sk, qsb, qss, qsh, ksb, kss, ksh, scale, causal, stream);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta_in = delta;
  a.out_a = dk;
  a.out_b = dv;
  return dispatch<Dkv>(a, dtype, D);
}

}  // extern "C"
