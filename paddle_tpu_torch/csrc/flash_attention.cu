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
// Every kernel: a block owns one (b*h, row tile) and loops over the
// other sequence inside the block. That loop replaces the TPU grid's
// sequential last axis, whose sums were carried across grid steps in VMEM
// scratch: CUDA blocks run in no order. Outputs round once to the input
// type; accumulation is fp32 throughout. No atomics: K2 owns dQ rows, K3
// owns dK/dV rows, so results are bitwise deterministic.
//
// Two designs. K1 on every dtype, and K2 and K3 on fp32, are the 3xTF32
// kernels below (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel): tiles staged in dynamic shared memory as fp32
// (K1's bf16 and fp16 widened on load), every product on the tensor cores
// with fp32 accuracy (K1's wgmma and TMA are later work):
//   * mma.sync m16n8k8 TF32 in the 3xTF32 scheme (CUTLASS's
//     OpMultiplyAddFastF32): each fp32 operand x splits in registers, when
//     its fragment is loaded, into hi = tf32(x) (rounded to nearest by two
//     integer ops) and lo = x - hi, and the product accumulates lo*hi +
//     hi*lo + hi*hi in fp32 (on an H100 at BERT-base, gradients within
//     about 2e-6 relative of an fp64 reference, against 4e-7 for fp32
//     FMAs and 5e-4 for plain TF32, hi*hi alone).
//     K1's bf16 and fp16 inputs are exact in TF32 (lo = 0: fp16's 10
//     mantissa bits are TF32's, and its exponent range lies inside
//     TF32's), and K1 rounds P to the input type before P*V, as the
//     reference does, so both its products take the hi*hi pass alone.
//     mma.sync and not wgmma: wgmma takes TF32 only K-major, and P*V,
//     dS*K, P^T*dO and dS^T*Q contract along the sequence (16-bit
//     operands have no such limit: K2 and K3 below).
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
//
// K2 and K3 on bf16 and fp16 are flash_bwd_dq_wgmma and
// flash_bwd_dkv_wgmma, redesigned for Hopper (they replaced the 3xTF32
// kernels' 16-bit instances, which widened tiles to fp32 in 135,680 B at
// D=128, ran one block of 4 warps an SM and took dS and P products in two
// TF32 passes):
//   * Tiles stay 16-bit in shared memory, in TMA's 128-byte swizzle, which
//     is the layout wgmma reads: D / 64 panels of [rows][64]. The block's
//     own tile (Q and dO in K2, K and V in K3) is 64 rows a consumer
//     warpgroup; the streamed one (K and V; Q and dO with their lse and
//     delta) comes in a ring of NST = 3 stages of 64 rows.
//   * Every product is one wgmma at the 16-bit rate with an fp32
//     accumulator, a warpgroup owning 64 rows: S = Q K^T, dP = dO V^T
//     (K3: S^T = K Q^T, dP^T = V dO^T) read both operands K-major from
//     shared memory (m64n64k16); dQ += dS K, dV += P^T dO and dK += dS^T Q
//     take A from registers, the accumulator of S or dP rounded to the
//     input type, and read B MN-major from the same swizzled tile
//     (m64nDk16, transposed B).
//   * Rounding as the reference: dS rounds to the input type before dQ +=
//     dS K and dK += dS^T Q (paddle_tpu/ops/flash_attention.py:313-315,
//     :350-352), P before dV += P^T dO (what the TPU's MXU does at default
//     precision to the reference's fp32 product, :347-349).
//   * One producer warp issues the TMA copies (tensor maps over the
//     [B, S, H, D] strides, rows past S read as zeros) and the lse and
//     delta rows, completing on mbarriers; consumers release a stage with
//     one arrival a warp. The consumers hold dK and dV (64 x D fp32 each)
//     with S and dP: at D=128 two consumer warpgroups and one block an SM
//     (168 registers a thread; K3 spills 292 bytes), at D=64 one, and
//     three blocks an SM of K2, two of K3.
//   * Causal: fully masked stages are skipped a warpgroup at a time, and
//     the grid launches the heaviest tiles first (late q tiles in K2,
//     early k tiles in K3), which shortens the last wave.
// What bounds them (chip_smoke.py computes it from each call's shapes):
// at GPT-3 1.3B's shape (B4 S2048 H16 D128, causal, bf16) operations: 3
// and 4 products over the causal triangle, 1.03e11 and 1.38e11 FLOP, take
// 104 and 139 us at 989 TFLOP/s, against 60 us for the bytes (six
// [B, S, H, D] tensors at 3.35 TB/s). The design runs every one of them
// once, at the 16-bit rate, from swizzled tiles that no thread copies.
// At BERT-base (B16 S128 H12 D64, bf16) bytes: 5.7 us each, against 1.2
// and 1.6 us of products; each byte is copied once by TMA, with the copy
// of the next stage in flight behind the products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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
  static_assert(std::is_same<T, float>::value, "fp32 only: bf16 and fp16 run the wgmma kernels");
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
          mma3<true, true>(s[j], qa, load_b_rows<PS>(cK, 8 * j, 8 * kk));
          mma3<true, true>(dp[j], da, load_b_rows<PS>(cV, 8 * j, 8 * kk));
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
        for (int n = 0; n < KD; ++n) mma3<true, true>(acc[n], a, load_b_cols<PS>(cK, 8 * j, 8 * n));
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
  static_assert(std::is_same<T, float>::value, "fp32 only: bf16 and fp16 run the wgmma kernels");
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
          mma3<true, true>(st[j], ka, load_b_rows<PS>(cQ, c0 + 8 * j, 8 * kk));
          mma3<true, true>(dpt[j], va, load_b_rows<PS>(cDO, c0 + 8 * j, 8 * kk));
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
          mma3<true, true>(dv_acc[n], pa, load_b_cols<PS>(cDO, c0 + 8 * j, 8 * n));
          mma3<true, true>(dk_acc[n], sa, load_b_cols<PS>(cQ, c0 + 8 * j, 8 * n));
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

// ---------------------------------------------------------------------------
// K2 and K3 on bf16 and fp16: flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma.
// 16-bit tiles in shared memory, every product one wgmma at the 16-bit
// rate, TMA copies into a ring that a producer warp keeps full.
// ---------------------------------------------------------------------------
constexpr int WGT = 128;       // threads a warpgroup
constexpr int TR = 64;         // rows a consumer warpgroup owns; rows a streamed stage
constexpr int NST = 3;         // stages of the ring

// D 128: two consumer warpgroups, one block an SM; D 64: one consumer
// warpgroup, three blocks an SM of K2 and two of K3. The producer is one
// warp after the consumers. ptxas allocates every thread of a kernel
// within its launch bounds, setmaxnreg or not (a producer warpgroup that
// handed its registers on left K3 spilling at 168 and 128), and counts a
// sub-partition's share of the register file: at D 128 the 9 warps put 3
// on one of the 4, so 168 registers a thread (K3 still spills 292 bytes).
template <int D> struct Cfg {
  static constexpr int NWG = D == 128 ? 2 : 1;        // consumer warpgroups
  static constexpr int THREADS = NWG * WGT + 32;      // and the producer warp
  static constexpr int MIN_BLOCKS_DQ = D == 128 ? 1 : 3;
  static constexpr int MIN_BLOCKS_DKV = D == 128 ? 1 : 2;
  static constexpr int OWN = NWG * TR;                // rows of the block's own tile
  static constexpr int OWN_TILE = OWN * D * 2;        // bytes of an own tile
  static constexpr int STAGE_TILE = TR * D * 2;       // bytes of a streamed tile
};

// Shared memory of both kernels, in bytes from a 1024-aligned base: two own
// tiles (K2: Q, dO; K3: K, V), NST stages of two streamed tiles (K2: K, V;
// K3: Q, dO), two fp32 rows (K2: lse and delta of the own rows; K3: of each
// stage's rows), the barriers full[NST], empty[NST] and own. A tile is D / 64
// panels of [rows][64] 16-bit values in TMA's 128-byte swizzle, the layout
// wgmma reads.
template <int D> struct Smem {
  using C = Cfg<D>;
  static constexpr int A = 0, B = C::OWN_TILE;                 // own tiles
  static constexpr int SA = 2 * C::OWN_TILE;                   // streamed tiles
  static constexpr int SB = SA + NST * C::STAGE_TILE;
  static constexpr int ROWS = C::OWN > NST * TR ? C::OWN : NST * TR;
  static constexpr int LSE = SB + NST * C::STAGE_TILE;         // float[ROWS]
  static constexpr int DELTA = LSE + 4 * ROWS;                 // float[ROWS]
  static constexpr int BAR = DELTA + 4 * ROWS;
  static constexpr size_t ALLOC = BAR + 8 * (2 * NST + 1) + 1024;   // + room to align
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` of TMA copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// waits for the phase of parity `parity` to complete; a phase that never
// completes (a lost arrival) traps after about 10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// a TMA copy of the [rows][64] box of a [B, S, H, D] tensor map at
// (d0, h, s0, b) into shared memory, completing on `bar`; rows past S read 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d0, int h,
                                         int s0, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0), "r"(b), "r"(bar)
      : "memory");
}
// rows [s0, s0 + ROWS) of head (b, h), all D / 64 panels, into the tile at dst
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int h, int s0,
                                         int b, uint32_t bar) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load(dst + p * ROWS * 128, map, 64 * p, h, s0, b, bar);
}

// wgmma descriptor of an operand in shared memory in the 128-byte swizzle:
// start address, leading byte offset `lbo`, stride byte offset 1024 (eight
// rows of 128 bytes), layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand: rows [r0, r0 + 64) of a tile of R rows, columns
// [16 kk, 16 kk + 16), 32 bytes into its panel's 128-byte rows
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return sw128_desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16);
}
// MN-major B operand: rows [k0, k0 + 16) of a tile of R rows are its K and
// its columns its N, the next 64 columns one panel (R x 128 bytes) on
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k0) {
  return sw128_desc(tile + k0 * 128, R * 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving an accumulator across an asynchronous wgmma
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PTT_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PTT_ACC64 \
  PTT_ACC32, \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTT_R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PTT_R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <typename T> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// d (+)= A B, m64n64k16, A (64 x 16) and B (16 x 64) K-major in shared
// memory; acc = 0 starts the sum
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
#define PTT_SS(TY)                                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PTT_R32   \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
               : PTT_ACC32                                                           \
               : "l"(a), "l"(b), "r"(acc))
  if constexpr (is_bf16<T>()) PTT_SS("bf16"); else PTT_SS("f16");
#undef PTT_SS
}

// d += A B, m64nNk16 (N = 64 or 128): A (64 x 16) from registers, four
// 16-bit pairs a thread in the accumulator's layout; B (16 x N) MN-major in
// shared memory
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
#define PTT_RS64(TY)                                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PTT_R32    \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
               : PTT_ACC32                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define PTT_RS128(TY)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " PTT_R64   \
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
               : PTT_ACC64                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (N == 64) {
    if constexpr (is_bf16<T>()) PTT_RS64("bf16"); else PTT_RS64("f16");
  } else {
    if constexpr (is_bf16<T>()) PTT_RS128("bf16"); else PTT_RS128("f16");
  }
#undef PTT_RS64
#undef PTT_RS128
}

// two fp32 values rounded to T, to nearest even, as one register (lo first)
template <typename T> __device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  uint32_t r;
  if constexpr (is_bf16<T>()) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&r, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&r, &v, 4);
  }
  return r;
}

// A 64 x 64 accumulator as the A operands, rounded to T, of the four k16
// steps of the next product: step kk takes columns 16 kk .. 16 kk + 15,
// which the accumulator holds in d[8 kk .. 8 kk + 7] in the order wgmma
// reads an A fragment (the layout below)
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m) a[kk][m] = pack16<T>(d[8 * kk + 2 * m], d[8 * kk + 2 * m + 1]);
}

// Each thread of a consumer warpgroup holds, of a 64 x N accumulator, rows
// g and g + 8 of its warp's 16 (g = lane / 4) and in each 8-column chunk j
// columns 8 j + 2 t and 8 j + 2 t + 1 (t = lane % 4): d[4 j + e] is row
// g + 8 (e >= 2), column 8 j + 2 t + (e & 1).

// ---------------------------------------------------------------------------
// K2 on 16-bit inputs: dQ = sum_k dS K, one block a (b*h, q tile of OWN
// rows), the key stages streamed; the prologue writes delta.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS_DQ)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                   Strides sq_st, Shape sh) {
  using C = Cfg<D>;
  using L = Smem<D>;
  constexpr int OWN = C::OWN, KD = D / 16;  // k16 steps of S and dP
  extern __shared__ __align__(1024) uint8_t wsmem[];
  const uint32_t raw = smem_u32(wsmem);
  uint8_t* sm = wsmem + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);
  const uint32_t full = base + L::BAR, empty = full + 8 * NST, own = empty + 8 * NST;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  // causal: the last q tiles see the most keys and launch first
  const int q0 = (sh.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * OWN;
  const int n_k = (sh.Sk + TR - 1) / TR;
  // causal: a key stage that starts after this q tile's last row is skipped
  const int end = sh.causal ? min(n_k, (q0 + OWN - 1) / TR + 1) : n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 32);            // the producer warp's lanes
      mbar_init(empty + 8 * s, 4 * C::NWG);   // lane 0 of each consumer warp
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::NWG * WGT) {        // the producer warp
    const int lane = threadIdx.x - C::NWG * WGT;
    if (lane == 0) {
      mbar_arrive_expect(own, 2 * C::OWN_TILE);
      tma_tile<D, OWN>(base + L::A, &mq, h, q0, b, own);
      tma_tile<D, OWN>(base + L::B, &mdo, h, q0, b, own);
    }
    for (int it = 0; it < end; ++it) {
      const int s = it % NST;
      mbar_wait(empty + 8 * s, ((it / NST) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect(full + 8 * s, 2 * C::STAGE_TILE);
        tma_tile<D, TR>(base + L::SA + s * C::STAGE_TILE, &mk, h, it * TR, b, full + 8 * s);
        tma_tile<D, TR>(base + L::SB + s * C::STAGE_TILE, &mv, h, it * TR, b, full + 8 * s);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const int tid = threadIdx.x % WGT, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = (threadIdx.x / WGT) * TR;       // the warpgroup's first row of the tile
  const int qw = q0 + rw;                         // and its q
  {  // delta = rowsum(dO * O) of the warp's 16 rows, 8 lanes a row
    const int sub = lane >> 3, part = lane & 7;
#pragma unroll
    for (int rr = 0; rr < 16; rr += 4) {     // unrolled: all loads in flight at once
      const int r = rw + 16 * w + rr + sub, s = q0 + r;
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
        const float l = s < sh.Sq ? lse[(int64_t)bh * sh.Sq + s] : NEG_INF;
        sDelta[r] = sum;
        // lse in log2 units; +inf for a row past Sq or with no key, so P = 0
        sLse[r] = l > NEG_INF * 0.5f ? l * LOG2E : INFINITY;
        if (s < sh.Sq) delta[(int64_t)bh * sh.Sq + s] = sum;
      }
    }
  }
  __syncwarp();
  const int r0 = rw + 16 * w + g, r1 = r0 + 8;   // the thread's two rows of the tile
  const int qp0 = q0 + r0, qp1 = q0 + r1;
  const float l0 = sLse[r0], l1 = sLse[r1], dl0 = sDelta[r0], dl1 = sDelta[r1];
  const float sl2 = sh.scale * LOG2E;             // exp(x scale) = exp2(x sl2)

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(own, 0);

  for (int it = 0; it < end; ++it) {
    const int s = it % NST, kb = it * TR;          // the stage's buffer and first key
    const uint32_t cK = base + L::SA + s * C::STAGE_TILE, cV = base + L::SB + s * C::STAGE_TILE;
    mbar_wait(full + 8 * s, (it / NST) & 1);
    // causal: nothing to do when the stage's first key lies after the
    // warpgroup's last row; nor for a warpgroup wholly past Sq
    if (qw < sh.Sq && (!sh.causal || kb <= qw + TR - 1)) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      fence_acc(sc);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)            // S = Q K^T
        wgmma_ss<T>(sc, desc_k<OWN>(base + L::A, rw, kk), desc_k<TR>(cK, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)            // dP = dO V^T
        wgmma_ss<T>(dp, desc_k<OWN>(base + L::B, rw, kk), desc_k<TR>(cV, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(sc);
      // P = exp(S scale - lse); masked: a key past Sk, or (causal) after the row
      const bool edge = kb + TR > sh.Sk || (sh.causal && kb + TR - 1 > qw);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool lower = i & 2;
        float p = exp2f(fmaf(sc[i], sl2, -(lower ? l1 : l0)));
        if (edge) {
          const int kp = kb + 8 * (i >> 2) + 2 * t + (i & 1);
          if (kp >= sh.Sk || (sh.causal && kp > (lower ? qp1 : qp0))) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_acc(dp);
      // dS = P (dP - delta) scale, rounded to T as the reference does before dS K
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0)) * sh.scale;
      uint32_t a[4][4];
      acc_to_a<T>(sc, a);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)             // dQ += dS K
        wgmma_rs<T, D>(acc, a[kk], desc_mn<TR>(cK, 16 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);    // the warp is done with buffer s
  }

  const int64_t row0 = b * sq_st.b + (int64_t)qp0 * sq_st.s + h * sq_st.h;
  const int64_t row1 = row0 + 8 * sq_st.s;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (qp0 < sh.Sq) store2(dq + row0 + c, acc[4 * n], acc[4 * n + 1]);
    if (qp1 < sh.Sq) store2(dq + row1 + c, acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// K3 on 16-bit inputs: dV = sum_q P^T dO and dK = sum_q dS^T Q, one block a
// (b*h, k tile of OWN rows), the q stages streamed with their lse and delta.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS_DKV)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, Strides sk_st, Shape sh) {
  using C = Cfg<D>;
  using L = Smem<D>;
  constexpr int OWN = C::OWN, KD = D / 16;
  extern __shared__ __align__(1024) uint8_t wsmem[];
  const uint32_t raw = smem_u32(wsmem);
  uint8_t* sm = wsmem + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_u32(sm);
  float* sLse = reinterpret_cast<float*>(sm + L::LSE);       // [NST][TR]
  float* sDelta = reinterpret_cast<float*>(sm + L::DELTA);   // [NST][TR]
  const uint32_t full = base + L::BAR, empty = full + 8 * NST, own = empty + 8 * NST;

  const int bh = blockIdx.x;
  const int b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.y * OWN;           // causal: the first k tiles see the most q rows
  const int n_q = (sh.Sq + TR - 1) / TR;
  // causal: a q stage whose last row lies before this k tile sees none of it
  const int i0 = sh.causal ? min(n_q, k0 / TR) : 0;
  const int n_st = n_q - i0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4 * C::NWG);
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::NWG * WGT) {        // the producer warp
    const int lane = threadIdx.x - C::NWG * WGT;
    if (lane == 0) {
      mbar_arrive_expect(own, 2 * C::OWN_TILE);
      tma_tile<D, OWN>(base + L::A, &mk, h, k0, b, own);
      tma_tile<D, OWN>(base + L::B, &mv, h, k0, b, own);
    }
    const float* lse_bh = lse + (int64_t)bh * sh.Sq;
    const float* delta_bh = delta + (int64_t)bh * sh.Sq;
    for (int it = 0; it < n_st; ++it) {
      const int s = it % NST, qb = (i0 + it) * TR;
      mbar_wait(empty + 8 * s, ((it / NST) & 1) ^ 1);
#pragma unroll
      for (int c = lane; c < TR; c += 32) {   // lse in log2 units (+inf: P = 0) and delta
        const int qp = qb + c;
        const float l = qp < sh.Sq ? lse_bh[qp] : NEG_INF;
        sLse[s * TR + c] = l > NEG_INF * 0.5f ? l * LOG2E : INFINITY;
        sDelta[s * TR + c] = qp < sh.Sq ? delta_bh[qp] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect(full + 8 * s, 2 * C::STAGE_TILE);
        tma_tile<D, TR>(base + L::SA + s * C::STAGE_TILE, &mq, h, qb, b, full + 8 * s);
        tma_tile<D, TR>(base + L::SB + s * C::STAGE_TILE, &mdo, h, qb, b, full + 8 * s);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const int tid = threadIdx.x % WGT, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = (threadIdx.x / WGT) * TR;       // the warpgroup's first row of the tile
  const int kw = k0 + rw;                         // and its key
  const int kp0 = kw + 16 * w + g, kp1 = kp0 + 8; // the thread's two keys
  const float sl2 = sh.scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(own, 0);

  for (int it = 0; it < n_st; ++it) {
    const int s = it % NST, qb = (i0 + it) * TR;   // the stage's buffer and first q row
    const uint32_t cQ = base + L::SA + s * C::STAGE_TILE, cDO = base + L::SB + s * C::STAGE_TILE;
    const float* cl = sLse + s * TR;
    const float* cd = sDelta + s * TR;
    mbar_wait(full + 8 * s, (it / NST) & 1);
    // causal: a stage whose last q row lies before the warpgroup's first
    // key; nor a warpgroup wholly past Sk
    if (kw < sh.Sk && (!sh.causal || qb + TR - 1 >= kw)) {
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      fence_acc(st);
      fence_acc(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)            // S^T = K Q^T
        wgmma_ss<T>(st, desc_k<OWN>(base + L::A, rw, kk), desc_k<TR>(cQ, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)            // dP^T = V dO^T
        wgmma_ss<T>(dpt, desc_k<OWN>(base + L::B, rw, kk), desc_k<TR>(cDO, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      // P^T in st and dS^T = P^T (dP^T - delta) scale in dpt; a q row past
      // Sq or with no key has lse +inf; causal masks q < k
      const bool edge = sh.causal && qb < kw + TR - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(cl + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(cd + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = exp2f(fmaf(st[i], sl2, -((e & 1) ? l2.y : l2.x)));
          if (edge && qb + 8 * j + 2 * t + (e & 1) < ((e & 2) ? kp1 : kp0)) p = 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * sh.scale;
        }
      }
      // both rounded to T, as the reference does before P^T dO and dS^T Q
      uint32_t pa[4][4], sa[4][4];
      acc_to_a<T>(st, pa);
      acc_to_a<T>(dpt, sa);
      fence_acc(dva);
      fence_acc(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)             // dV += P^T dO
        wgmma_rs<T, D>(dva, pa[kk], desc_mn<TR>(cDO, 16 * kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)             // dK += dS^T Q
        wgmma_rs<T, D>(dka, sa[kk], desc_mn<TR>(cQ, 16 * kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);    // the warp is done with buffer s
  }

  const int64_t row0 = b * sk_st.b + (int64_t)kp0 * sk_st.s + h * sk_st.h;
  const int64_t row1 = row0 + 8 * sk_st.s;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (kp0 < sh.Sk) {
      store2(dk + row0 + c, dka[4 * n], dka[4 * n + 1]);
      store2(dv + row0 + c, dva[4 * n], dva[4 * n + 1]);
    }
    if (kp1 < sh.Sk) {
      store2(dk + row1 + c, dka[4 * n + 2], dka[4 * n + 3]);
      store2(dv + row1 + c, dva[4 * n + 2], dva[4 * n + 3]);
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

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The TMA map of a [B, S, H, D] 16-bit tensor, boxes of [rows][64] in the
// 128-byte swizzle; rows past S read as zeros. A dimension of size 1 takes
// the stride a contiguous tensor would have (torch leaves it free).
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t H,
                       int64_t D, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  if (H == 1) st.h = D;
  if (S == 1) st.s = st.h * H;
  if (B == 1) st.b = st.s * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, is_bf16<T>() ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
      const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t launch_dq16(const Args& a) {
  using C = Cfg<D>;
  const int64_t H = a.sh.H, Sq = a.sh.Sq, Sk = a.sh.Sk;
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err;
  if ((err = tensor_map<T>(&mq, a.q, a.B, Sq, H, D, a.sq_st, C::OWN)) != cudaSuccess ||
      (err = tensor_map<T>(&mdo, a.dout, a.B, Sq, H, D, a.sq_st, C::OWN)) != cudaSuccess ||
      (err = tensor_map<T>(&mk, a.k, a.B, Sk, H, D, a.sk_st, TR)) != cudaSuccess ||
      (err = tensor_map<T>(&mv, a.v, a.B, Sk, H, D, a.sk_st, TR)) != cudaSuccess)
    return err;
  const size_t smem = Smem<D>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * H), (unsigned)((Sq + C::OWN - 1) / C::OWN));
  flash_bwd_dq_wgmma<T, D><<<grid, C::THREADS, smem, a.stream>>>(
      mq, mdo, mk, mv, (const T*)a.o, (const T*)a.dout, a.lse, a.delta_out, (T*)a.out_o,
      a.sq_st, a.sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv16(const Args& a) {
  using C = Cfg<D>;
  const int64_t H = a.sh.H, Sq = a.sh.Sq, Sk = a.sh.Sk;
  CUtensorMap mk, mv, mq, mdo;
  cudaError_t err;
  if ((err = tensor_map<T>(&mk, a.k, a.B, Sk, H, D, a.sk_st, C::OWN)) != cudaSuccess ||
      (err = tensor_map<T>(&mv, a.v, a.B, Sk, H, D, a.sk_st, C::OWN)) != cudaSuccess ||
      (err = tensor_map<T>(&mq, a.q, a.B, Sq, H, D, a.sq_st, TR)) != cudaSuccess ||
      (err = tensor_map<T>(&mdo, a.dout, a.B, Sq, H, D, a.sq_st, TR)) != cudaSuccess)
    return err;
  const size_t smem = Smem<D>::ALLOC;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(a.B * H), (unsigned)((Sk + C::OWN - 1) / C::OWN));
  flash_bwd_dkv_wgmma<T, D><<<grid, C::THREADS, smem, a.stream>>>(
      mk, mv, mq, mdo, a.lse, a.delta_in, (T*)a.out_a, (T*)a.out_b, a.sk_st, a.sh);
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
// K2 and K3: fp32 on the 3xTF32 kernels, bf16 and fp16 on the wgmma ones
template <typename T, int D> struct Dq {
  static cudaError_t run(const Args& a) {
    if constexpr (std::is_same<T, float>::value) return launch_dq<T, D>(a);
    else return launch_dq16<T, D>(a);
  }
};
template <typename T, int D> struct Dkv {
  static cudaError_t run(const Args& a) {
    if constexpr (std::is_same<T, float>::value) return launch_dkv<T, D>(a);
    else return launch_dkv16<T, D>(a);
  }
};
template <typename T, int D> struct Occ {
  static cudaError_t run(const int& which, int* const& info) {
    if (which == 0) return occupancy(flash_fwd_kernel<T, D>, BNT, fwd_smem<D>(), BR, info);
    if constexpr (std::is_same<T, float>::value) {
      if (which == 1) return occupancy(flash_bwd_dq_kernel<T, D>, BNT, bwd_smem<D>(), BR, info);
      return occupancy(flash_bwd_dkv_kernel<T, D>, BNT, bwd_smem<D>(), BR, info);
    } else {
      if (which == 1)
        return occupancy(flash_bwd_dq_wgmma<T, D>, Cfg<D>::THREADS, Smem<D>::ALLOC, Cfg<D>::OWN,
                         info);
      return occupancy(flash_bwd_dkv_wgmma<T, D>, Cfg<D>::THREADS, Smem<D>::ALLOC, Cfg<D>::OWN,
                       info);
    }
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
