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
// Every kernel: a block owns one (b*h, 64-row tile) and loops over the
// other sequence inside the block. That loop replaces the TPU grid's
// sequential last axis, whose sums were carried across grid steps in VMEM
// scratch: CUDA blocks run in no order. Tiles are staged in dynamic shared
// memory as fp32 (bf16 and fp16 inputs are widened on load); outputs round
// once to the input type; accumulation is fp32 throughout. No atomics: K2 owns dQ
// rows, K3 owns dK/dV rows, so results are bitwise deterministic.
//
// All three kernels run every product on the tensor cores, with fp32
// accuracy (wgmma and TMA are later work):
//   * mma.sync m16n8k8 TF32 in the 3xTF32 scheme (CUTLASS's
//     OpMultiplyAddFastF32): each fp32 operand x splits in registers, when
//     its fragment is loaded, into hi = tf32(x) (rounded to nearest by two
//     integer ops) and lo = x - hi, and the product accumulates lo*hi +
//     hi*lo + hi*hi in fp32 (on an H100 at BERT-base, gradients within
//     about 2e-6 relative of an fp64 reference, against 4e-7 for fp32
//     FMAs and 5e-4 for plain TF32, hi*hi alone).
//     bf16 and fp16 inputs are exact in TF32 (lo = 0: fp16's 10 mantissa
//     bits are TF32's, and its exponent range lies inside TF32's): a
//     product of two staged input tiles (S, dP) takes the hi*hi pass
//     alone, and one whose A is the fp32 P or dS takes two (lo*hi,
//     hi*hi); K1 rounds P to the input type before P*V, as the reference
//     does, so both its products take one.
//     mma.sync and not wgmma: wgmma takes TF32 only K-major, and P*V,
//     dS*K, P^T*dO and dS^T*Q contract along the sequence.
//   * A block is 4 warps; each warp owns 16 rows of the 64-row tile (q rows
//     in K1 and K2, k rows in K3). K3 computes the transposed tiles
//     S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T, the A operands of
//     dV += P^T dO and dK += dS^T Q, are rows the warp already holds.
//   * The accumulator of the first product becomes the A operand of the
//     second in registers, with no shuffle and no shared memory: the
//     contraction order inside an 8-wide step is free, so A's k-slot t is
//     taken as column 2t and slot t+4 as column 2t+1 (exactly the
//     accumulator's c0/c1), and the B operand reads its rows in that order.
//   * Tiles are fp32 rows padded to D+4 floats (16-byte aligned rows; the
//     fragment reads hit banks 4g+t or 8t+g, all 32 distinct), filled with
//     16-byte cp.async copies (zero-fill past S). The block's own tile (Q
//     in K1, Q and dO in K2, K and V in K3) is 64 rows; the streamed one
//     comes in two 32-row stages, so the next stage loads while this one
//     computes, in the room of one 64-row tile. That is 68.5 KB at D=64
//     for K2 and K3 (51 KB for K1), so 3 blocks of 128 threads fit an SM:
//     the BERT-base grid (192 x 2 = 384 blocks) runs in one wave on 132
//     SMs.
//   * Masks at fragment granularity: a masked score (k >= Sk, q >= Sq,
//     causal k > q) or a row whose lse is NEG_INF gives P = 0; causal stages
//     and passes a warp cannot see are skipped; nothing is written past S.
//   * K2's prologue reads O and dO with 16-byte coalesced loads (8 lanes a
//     row) and writes delta = rowsum(dO * O) once a row; K3, launched after
//     it on the same stream, reads it.
//   * K1 keeps S and P in the accumulator registers and the online softmax
//     in the warp: thread (g, t) holds rows g and g+8 of its warp's 16, so
//     a row's running max m is a max over the thread's 8 scores of a stage
//     and two shuffles (lanes 1, 2), and its running sum l a per-thread
//     share that is summed across the four lanes once, at the end. One
//     barrier a stage: the copy of stage i+1 starts right after it, into
//     the buffer every warp has left by then.
// What bounds K1 at BERT-base fp32: bytes. Four [B, S, H, D] tensors (q,
// k, v in, o out) at 3.35 TB/s take 7.5 us; its two [S, S, D] products in
// 3xTF32 (three passes at 495 TFLOP/s) take 4.9 us, on the fp32 CUDA cores
// 12.0 us. The design moves each byte once (Q staged once a
// block, K and V once a q tile, S and P never leave the registers) and
// keeps the next stage's copy in flight behind the products. On an H100
// it runs in about 23 us, a third of the byte bound: the copies, barriers
// and epilogue alone (no products) take 10.6 us, the lo passes and splits
// 7.8 us (hi*hi alone: 15.2 us).
// What bounds K2 and K3 at BERT-base fp32: bytes too. Six [B, S, H, D]
// tensors each at 3.35 TB/s take 11.3 us; the 3xTF32 products (3 and 4 [S, S, D]
// products, three passes each at 495 TFLOP/s) take 7.3 and 9.8 us, the
// same products on the fp32 CUDA cores 18.0 and 24.0 us. chip_smoke.py
// computes these bounds from each call's shapes. The kernels reach about
// a third of the byte bound. The lo passes and the splits take about a
// third of their time (hi*hi alone runs them in 24-26 us against 35-41);
// the rest is the instructions around each mma (scalar fragment loads,
// softmax and mask arithmetic) and the barriers.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f; // the reference's lse of an empty row

struct Strides {   // element strides of a [B, S, H, D] tensor; stride of D is 1
  int64_t b, s, h;
};

struct Shape {
  int H, Sq, Sk;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// Tensor-core helpers (mma.sync m16n8k8 TF32, 3xTF32)
// ---------------------------------------------------------------------------
constexpr int BW = 4;          // warps a block
constexpr int BNT = 32 * BW;   // threads a block
constexpr int BR = 16 * BW;    // rows a tile, 16 a warp
constexpr int SR = BR / 2;     // rows a stage of the streamed tile; two stages

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of the committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive values of a row (16 bytes of fp32, 8 of bf16 or fp16) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// x rounded to T's precision, to nearest even, as fp32
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, const __half*) {
  return __half2float(__float2half_rn(x));
}

// Rows [row0, row0 + ROWS) of head (b, h) into a [ROWS][D+4] fp32 tile;
// rows at or past `len` are zero. fp32 goes by cp.async (the caller commits
// and waits); bf16 and fp16 are widened through registers.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, Strides st, int b, int h,
                                           int row0, int len) {
  constexpr int PS = D + 4, C4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += BNT) {
    const int r = i / C4, c = (i % C4) * 4;
    const int s = row0 + r;
    const bool ok = s < len;
    const T* p = src + (ok ? b * st.b + s * st.s + h * st.h + c : 0);
    float* d = dst + r * PS + c;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(d, p, ok);
    } else {
      *reinterpret_cast<float4*>(d) = ok ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

struct FragA {   // a 16x8 A operand, split: thread (g, t) holds (g|g+8, t|t+4)
  uint32_t hi[4], lo[4];
};
struct FragB {   // an 8x8 B operand, split: thread (g, t) holds (k t|t+4, n g)
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32's 10 mantissa bits, to nearest (ties away): two
// integer ops, where cvt.rna.tf32.f32 cost K3 a fifth of its time on an
// H100 (and a spill);
// lo = x - hi is exact, and the mma reads its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi. An
// operand that is exact in TF32 (a staged bf16 input: its lo is 0) has
// A_LO / B_LO false, and the pass that would add lo * hi = 0 is not run.
// c is a 16x8 accumulator: thread (g, t) holds (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1) in c[0..3].
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void mma3(float* c, const FragA& a, const FragB& b) {
  if constexpr (A_LO) mma_tf32(c, a.lo, b.hi);
  if constexpr (B_LO) mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A operand: rows r0..r0+15, columns d0..d0+7 of a staged tile
template <int PS>
__device__ __forceinline__ FragA load_a(const float* tile, int r0, int d0) {
  const float* p = tile + (r0 + lane_g()) * PS + d0 + lane_t();
  return frag_a(p[0], p[8 * PS], p[4], p[8 * PS + 4]);
}

// B operand of X Y^T: n = tile rows n0..n0+7, k = columns d0..d0+7
template <int PS>
__device__ __forceinline__ FragB load_b_rows(const float* tile, int n0, int d0) {
  const float* p = tile + (n0 + lane_g()) * PS + d0 + lane_t();
  return frag_b(p[0], p[4]);
}

// B operand of C Z: k = tile rows k0..k0+7 in the order acc_as_a uses
// (slot t is row k0+2t, slot t+4 row k0+2t+1), n = columns n0..n0+7
template <int PS>
__device__ __forceinline__ FragB load_b_cols(const float* tile, int k0, int n0) {
  const float* p = tile + (k0 + 2 * lane_t()) * PS + n0 + lane_g();
  return frag_b(p[0], p[PS]);
}

// A 16x8 accumulator as the A operand of the next product, in that order
__device__ __forceinline__ FragA acc_as_a(const float* c) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// K1: the Q tile and two stages of K and of V
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (BR + 4 * SR) * (D + 4);
}

// K2: the Q and dO tiles, two stages of K and of V, lse, delta; K3: the K
// and V tiles, two stages of Q, dO, lse and delta
template <int D> constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * BR * (D + 4) + 2 * BR);
}

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// K1: o = softmax(mask(q k^T * scale)) v and lse = m + log l, one block a
// (b*h, q tile), the online softmax over 32-key stages in registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BNT, D == 64 ? 3 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq_st, Strides sk_st,
                 Shape sh) {
  constexpr int PS = D + 4;
  constexpr int KD = D / 8;                 // 8-wide steps over the head dim
  constexpr int NJ = SR / 8;                // 8-key steps a stage
  constexpr bool X = std::is_same<T, float>::value;   // inputs and P have a lo part
  extern __shared__ __align__(16) float bsmem[];
  float* sQ = bsmem;
  float* sK = sQ + BR * PS;                 // [2][SR][PS]
  float* sV = sK + 2 * SR * PS;             // [2][SR][PS]

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.y * BR;
  const int g = lane_g(), t = lane_t();
  const int wr = 16 * (threadIdx.x >> 5);   // the warp's first row of the tile
  const int qp0 = q0 + wr + g, qp1 = qp0 + 8;   // the thread's two q rows
  const int n_k = (sh.Sk + SR - 1) / SR;
  // causal: a key stage that starts after this q tile's last row is skipped
  const int end = sh.causal ? min(n_k, (q0 + BR - 1) / SR + 1) : n_k;
  const float sl2 = sh.scale * LOG2E;       // exp(x scale) = exp2(x sl2)
  auto stage_kv = [&](int i) {              // keys [i SR, i SR + SR) into buffer i & 1
    stage_tile<T, D, SR>(sK + (i & 1) * SR * PS, k, sk_st, b, h, i * SR, sh.Sk);
    stage_tile<T, D, SR>(sV + (i & 1) * SR * PS, v, sk_st, b, h, i * SR, sh.Sk);
  };

  if (end > 0) {
    stage_tile<T, D, BR>(sQ, q, sq_st, b, h, q0, sh.Sq);
    stage_kv(0);
    cp_async_commit();
  }

  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the running max of the raw scores q.k of rows qp0 and qp1 (-inf until
  // they see a key) and this thread's share of their running sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < end; ++i) {
    const float* cK = sK + (i & 1) * SR * PS;
    const float* cV = sV + (i & 1) * SR * PS;
    const int kb = i * SR;                  // the stage's first key
    cp_async_wait<0>();                     // stage i, the one group in flight, has landed
    __syncthreads();                        // for all; every warp is done with stage i - 1
    if (i + 1 < end) {                      // so its buffer takes stage i + 1
      stage_kv(i + 1);
      cp_async_commit();
    }
    // causal: nothing to do when the stage's first key lies after the warp's last row
    if (sh.causal && kb > q0 + wr + 15) continue;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {       // S = Q K^T
      const FragA qa = load_a<PS>(sQ, wr, 8 * kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // each 8-wide step sums in a fresh accumulator and is added to S
        // rounded to nearest: the tensor cores truncate what they add to
        // a large accumulator, and exp(S) magnifies S's error
        float c8[4] = {0.f, 0.f, 0.f, 0.f};
        mma3<X, X>(c8, qa, load_b_rows<PS>(cK, 8 * j, 8 * kk));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += c8[e];
      }
    }
    // a key past Sk, or (causal) after the row, scores -inf; only a stage
    // that holds such a key for some row of the warp looks
    if (kb + SR > sh.Sk || (sh.causal && kb + SR - 1 > q0 + wr)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kb + 8 * j + 2 * t + (e & 1);
          if (kp >= sh.Sk || (sh.causal && kp > (e >= 2 ? qp1 : qp0))) s[j][e] = -INFINITY;
        }
    }
    float mx0 = m0, mx1 = m1;               // the rows' new running max
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // P = exp2(s sl2 - c) and the rescale alpha = exp2(m sl2 - c), c the
    // new max in log2 units; a row that has seen no key keeps m = -inf and
    // takes c = 0, so its P is 0 (its acc and l are still 0)
    const float c0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float c1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float a0 = exp2f(fmaf(m0, sl2, -c0)), a1 = exp2f(fmaf(m1, sl2, -c1));
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e >= 2;
        float p = exp2f(fmaf(s[j][e], sl2, lower ? -c1 : -c0));
        if (lower) l1 += p; else l0 += p;
        // bf16, fp16: P rounds to V's type before P V, as in the reference
        // (l sums it unrounded); then it is exact in TF32 and needs no lo pass
        if constexpr (!X) p = round_to(p, static_cast<const T*>(nullptr));
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {          // O += P V
      const FragA pa = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < KD; ++n) mma3<X, X>(acc[n], pa, load_b_cols<PS>(cV, 8 * j, 8 * n));
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int64_t row0 = b * sq_st.b + (int64_t)qp0 * sq_st.s + h * sq_st.h;
  const int64_t row1 = row0 + 8 * sq_st.s;
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    const int c = 8 * n + 2 * t;
    if (qp0 < sh.Sq) store2(o + row0 + c, acc[n][0] * inv0, acc[n][1] * inv0);
    if (qp1 < sh.Sq) store2(o + row1 + c, acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {                             // an empty row: o = 0, lse = NEG_INF
    float* lse_bh = lse + (int64_t)bh * sh.Sq;
    if (qp0 < sh.Sq) lse_bh[qp0] = l0 > 0.f ? m0 * sh.scale + logf(l0) : NEG_INF;
    if (qp1 < sh.Sq) lse_bh[qp1] = l1 > 0.f ? m1 * sh.scale + logf(l1) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// K2: dQ = sum_k dS k, one block a (b*h, q tile); the prologue writes delta.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BNT, D == 64 ? 3 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, Strides sq_st, Strides sk_st, Shape sh) {
  constexpr int PS = D + 4;
  constexpr int KD = D / 8;                 // 8-wide steps over the head dim
  constexpr int NJ = SR / 8;                // 8-key steps a stage
  constexpr bool X = std::is_same<T, float>::value;   // staged inputs have a lo part
  extern __shared__ __align__(16) float bsmem[];
  float* sQ = bsmem;
  float* sDO = sQ + BR * PS;
  float* sK = sDO + BR * PS;                // [2][SR][PS]
  float* sV = sK + 2 * SR * PS;             // [2][SR][PS]
  float* sLse = sV + 2 * SR * PS;
  float* sDelta = sLse + BR;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.y * BR;
  const int lane = threadIdx.x & 31, g = lane_g(), t = lane_t();
  const int wr = 16 * (threadIdx.x >> 5);   // the warp's first row of the tile
  const int n_k = (sh.Sk + SR - 1) / SR;
  // causal: a key stage that starts after this q tile's last row is skipped
  const int end = sh.causal ? min(n_k, (q0 + BR - 1) / SR + 1) : n_k;
  auto stage_kv = [&](int i) {              // keys [i SR, i SR + SR) into buffer i & 1
    stage_tile<T, D, SR>(sK + (i & 1) * SR * PS, k, sk_st, b, h, i * SR, sh.Sk);
    stage_tile<T, D, SR>(sV + (i & 1) * SR * PS, v, sk_st, b, h, i * SR, sh.Sk);
  };

  stage_tile<T, D, BR>(sQ, q, sq_st, b, h, q0, sh.Sq);
  stage_tile<T, D, BR>(sDO, dout, sq_st, b, h, q0, sh.Sq);
  if (end > 0) stage_kv(0);
  cp_async_commit();
  if (end > 1) stage_kv(1);
  cp_async_commit();

  {  // delta = rowsum(dO * O) of the warp's 16 rows, 8 lanes a row
    const int sub = lane >> 3, part = lane & 7;
#pragma unroll
    for (int rr = 0; rr < 16; rr += 4) {   // unrolled: all loads in flight at once
      const int r = wr + rr + sub, s = q0 + r;
      float sum = 0.f;
      if (s < sh.Sq) {
        const int64_t off = b * sq_st.b + s * sq_st.s + h * sq_st.h;
#pragma unroll
        for (int d = 4 * part; d < D; d += 32) {
          const float4 x = load4(o + off + d), y = load4(dout + off + d);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
          sum = fmaf(x.z, y.z, sum);
          sum = fmaf(x.w, y.w, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (part == 0) {
        sDelta[r] = sum;
        sLse[r] = s < sh.Sq ? lse[(int64_t)bh * sh.Sq + s] : NEG_INF;
        if (s < sh.Sq) delta[(int64_t)bh * sh.Sq + s] = sum;
      }
    }
  }
  __syncwarp();
  const int r0 = wr + g, r1 = r0 + 8;       // the thread's two rows of the tile
  const int qp0 = q0 + r0, qp1 = q0 + r1;
  const float lse0 = sLse[r0], lse1 = sLse[r1];
  const float dl0 = sDelta[r0], dl1 = sDelta[r1];
  const bool ok0 = qp0 < sh.Sq && lse0 > NEG_INF * 0.5f;
  const bool ok1 = qp1 < sh.Sq && lse1 > NEG_INF * 0.5f;

  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < end; ++i) {
    const float* cK = sK + (i & 1) * SR * PS;
    const float* cV = sV + (i & 1) * SR * PS;
    const int kb = i * SR;                  // the stage's first key
    cp_async_wait<1>();                     // stage i has landed; i + 1 may be in flight
    __syncthreads();
    // causal: nothing to do when the stage's first key lies after the warp's last row
    if (!sh.causal || kb <= q0 + wr + 15) {
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {     // S = Q K^T, dP = dO V^T
        const FragA qa = load_a<PS>(sQ, wr, 8 * kk);
        const FragA da = load_a<PS>(sDO, wr, 8 * kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3<X, X>(s[j], qa, load_b_rows<PS>(cK, 8 * j, 8 * kk));
          mma3<X, X>(dp[j], da, load_b_rows<PS>(cV, 8 * j, 8 * kk));
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)          // P, then dS = P (dP - delta) scale in s
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lower = e >= 2;
          const int kp = kb + 8 * j + 2 * t + (e & 1);
          const bool ok = (lower ? ok1 : ok0) && kp < sh.Sk &&
                          (!sh.causal || kp <= (lower ? qp1 : qp0));
          const float p = ok ? expf(s[j][e] * sh.scale - (lower ? lse1 : lse0)) : 0.f;
          s[j][e] = p * (dp[j][e] - (lower ? dl1 : dl0)) * sh.scale;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {        // dQ += dS K
        const FragA a = acc_as_a(s[j]);
#pragma unroll
        for (int n = 0; n < KD; ++n) mma3<true, X>(acc[n], a, load_b_cols<PS>(cK, 8 * j, 8 * n));
      }
    }
    __syncthreads();                        // every warp is done with buffer i & 1
    if (i + 2 < end) stage_kv(i + 2);
    cp_async_commit();                      // (maybe empty: keeps one group a stage)
  }

  const int64_t row0 = b * sq_st.b + (int64_t)qp0 * sq_st.s + h * sq_st.h;
  const int64_t row1 = row0 + 8 * sq_st.s;
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    const int c = 8 * n + 2 * t;
    if (qp0 < sh.Sq) store2(dq + row0 + c, acc[n][0], acc[n][1]);
    if (qp1 < sh.Sq) store2(dq + row1 + c, acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// K3: dV = sum_q P^T dO and dK = sum_q dS^T q, one block a (b*h, k tile).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(BNT, D == 64 ? 3 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq_st, Strides sk_st, Shape sh) {
  constexpr int PS = D + 4;
  constexpr int KD = D / 8;
  constexpr int NC = D == 64 ? SR : SR / 2;   // q columns a pass (registers: NC + D)
  constexpr int NJ = NC / 8;
  constexpr bool X = std::is_same<T, float>::value;   // staged inputs have a lo part
  extern __shared__ __align__(16) float bsmem[];
  float* sK = bsmem;
  float* sV = sK + BR * PS;
  float* sQ = sV + BR * PS;                 // [2][SR][PS]
  float* sDO = sQ + 2 * SR * PS;            // [2][SR][PS]
  float* sLse = sDO + 2 * SR * PS;          // [2][SR]
  float* sDelta = sLse + 2 * SR;            // [2][SR]

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.y * BR;
  const int g = lane_g(), t = lane_t();
  const int wr = 16 * (threadIdx.x >> 5);
  const int kp0 = k0 + wr + g, kp1 = kp0 + 8;   // the thread's two k rows
  const int n_q = (sh.Sq + SR - 1) / SR;
  // causal: a q stage whose last row lies before this k tile sees none of it
  const int i0 = sh.causal ? k0 / SR : 0;
  const float* lse_bh = lse + (int64_t)bh * sh.Sq;
  const float* delta_bh = delta + (int64_t)bh * sh.Sq;
  auto stage_q = [&](int i) {               // q rows [i SR, i SR + SR) into buffer (i - i0) & 1
    const int buf = (i - i0) & 1;
    stage_tile<T, D, SR>(sQ + buf * SR * PS, q, sq_st, b, h, i * SR, sh.Sq);
    stage_tile<T, D, SR>(sDO + buf * SR * PS, dout, sq_st, b, h, i * SR, sh.Sq);
    if (threadIdx.x < SR) {                 // past Sq: 0, and the q mask drops the column
      const int s = i * SR + threadIdx.x;
      const bool ok = s < sh.Sq;
      cp_async4(sLse + buf * SR + threadIdx.x, lse_bh + (ok ? s : 0), ok);
      cp_async4(sDelta + buf * SR + threadIdx.x, delta_bh + (ok ? s : 0), ok);
    }
  };

  stage_tile<T, D, BR>(sK, k, sk_st, b, h, k0, sh.Sk);
  stage_tile<T, D, BR>(sV, v, sk_st, b, h, k0, sh.Sk);
  if (i0 < n_q) stage_q(i0);
  cp_async_commit();
  if (i0 + 1 < n_q) stage_q(i0 + 1);
  cp_async_commit();

  float dk_acc[KD][4], dv_acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = i0; i < n_q; ++i) {
    const int buf = (i - i0) & 1;
    const float* cQ = sQ + buf * SR * PS;
    const float* cDO = sDO + buf * SR * PS;
    const float* cLse = sLse + buf * SR;
    const float* cDelta = sDelta + buf * SR;
    const int qb = i * SR;                  // the stage's first q row
    cp_async_wait<1>();                     // stage i has landed; i + 1 may be in flight
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < SR; c0 += NC) {
      // causal: a pass whose last q lies before the warp's first k row
      if (sh.causal && qb + c0 + NC - 1 < k0 + wr) continue;
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {     // S^T = K Q^T, dP^T = V dO^T
        const FragA ka = load_a<PS>(sK, wr, 8 * kk);
        const FragA va = load_a<PS>(sV, wr, 8 * kk);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3<X, X>(st[j], ka, load_b_rows<PS>(cQ, c0 + 8 * j, 8 * kk));
          mma3<X, X>(dpt[j], va, load_b_rows<PS>(cDO, c0 + 8 * j, 8 * kk));
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {        // P^T in st, dS^T in dpt
        const int qc = c0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(cLse + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(cDelta + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = e & 1;
          const int qp = qb + qc + col, kp = e >= 2 ? kp1 : kp0;
          const float l = col ? l2.y : l2.x, dl = col ? d2.y : d2.x;
          const bool ok = kp < sh.Sk && qp < sh.Sq && l > NEG_INF * 0.5f &&
                          (!sh.causal || qp >= kp);
          const float p = ok ? expf(st[j][e] * sh.scale - l) : 0.f;
          dpt[j][e] = p * (dpt[j][e] - dl) * sh.scale;
          st[j][e] = p;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {        // dV += P^T dO, dK += dS^T Q
        const FragA pa = acc_as_a(st[j]);
        const FragA sa = acc_as_a(dpt[j]);
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          mma3<true, X>(dv_acc[n], pa, load_b_cols<PS>(cDO, c0 + 8 * j, 8 * n));
          mma3<true, X>(dk_acc[n], sa, load_b_cols<PS>(cQ, c0 + 8 * j, 8 * n));
        }
      }
    }
    __syncthreads();                        // every warp is done with this buffer
    if (i + 2 < n_q) stage_q(i + 2);
    cp_async_commit();                      // (maybe empty: keeps one group a stage)
  }

  const int64_t row0 = b * sk_st.b + (int64_t)kp0 * sk_st.s + h * sk_st.h;
  const int64_t row1 = row0 + 8 * sk_st.s;
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    const int c = 8 * n + 2 * t;
    if (kp0 < sh.Sk) {
      store2(dk + row0 + c, dk_acc[n][0], dk_acc[n][1]);
      store2(dv + row0 + c, dv_acc[n][0], dv_acc[n][1]);
    }
    if (kp1 < sh.Sk) {
      store2(dk + row1 + c, dk_acc[n][2], dk_acc[n][3]);
      store2(dv + row1 + c, dv_acc[n][2], dv_acc[n][3]);
    }
  }
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
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sq + BR - 1) / BR));
  flash_fwd_kernel<T, D><<<grid, BNT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out_o, a.lse_out, a.sq_st, a.sk_st,
      a.sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sq + BR - 1) / BR));
  flash_bwd_dq_kernel<T, D><<<grid, BNT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o, (const T*)a.dout, a.lse,
      a.delta_out, (T*)a.out_o, a.sq_st, a.sk_st, a.sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * a.sh.H), (unsigned)((a.sh.Sk + BR - 1) / BR));
  flash_bwd_dkv_kernel<T, D><<<grid, BNT, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse, a.delta_in,
      (T*)a.out_a, (T*)a.out_b, a.sq_st, a.sk_st, a.sh);
  return cudaGetLastError();
}

// Blocks an SM holds of one kernel, into info: {blocks, threads, dynamic
// shared bytes, rows a tile}
template <typename K>
cudaError_t occupancy(K kernel, int threads, size_t smem, int rows, int* info) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  info[1] = threads;
  info[2] = (int)smem;
  info[3] = rows;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, threads, smem);
}

// dtype 0 = float32, 1 = bfloat16, 2 = float16; head dim 64 or 128.
// (flash_attention.py pads a smaller head dim with zeros to one of these.)
template <template <typename, int> class L, typename... X>
int dispatch(int dtype, int64_t D, const X&... x) {
  if (dtype == 0 && D == 64) return (int)L<float, 64>::run(x...);
  if (dtype == 0 && D == 128) return (int)L<float, 128>::run(x...);
  if (dtype == 1 && D == 64) return (int)L<__nv_bfloat16, 64>::run(x...);
  if (dtype == 1 && D == 128) return (int)L<__nv_bfloat16, 128>::run(x...);
  if (dtype == 2 && D == 64) return (int)L<__half, 64>::run(x...);
  if (dtype == 2 && D == 128) return (int)L<__half, 128>::run(x...);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D> struct Fwd { static cudaError_t run(const Args& a) { return launch_fwd<T, D>(a); } };
template <typename T, int D> struct Dq { static cudaError_t run(const Args& a) { return launch_dq<T, D>(a); } };
template <typename T, int D> struct Dkv { static cudaError_t run(const Args& a) { return launch_dkv<T, D>(a); } };
template <typename T, int D> struct Occ {
  static cudaError_t run(const int& which, int* const& info) {
    if (which == 0) return occupancy(flash_fwd_kernel<T, D>, BNT, fwd_smem<D>(), BR, info);
    if (which == 1) return occupancy(flash_bwd_dq_kernel<T, D>, BNT, bwd_smem<D>(), BR, info);
    return occupancy(flash_bwd_dkv_kernel<T, D>, BNT, bwd_smem<D>(), BR, info);
  }
};

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
  return dispatch<Fwd>(dtype, D, a);
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
  return dispatch<Dq>(dtype, D, a);
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
  return dispatch<Dkv>(dtype, D, a);
}

// kernel 0 = K1, 1 = K2, 2 = K3; info as occupancy() above
int ptt_flash_occupancy(int kernel, int dtype, int64_t D, int* info) {
  return dispatch<Occ>(dtype, D, kernel, info);
}

}  // extern "C"
