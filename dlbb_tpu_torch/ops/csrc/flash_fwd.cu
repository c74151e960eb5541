// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out + fp32 lse.
//
// Replaces: dlbb_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel), computing the same function:
//   s = q . k^T * sm_scale (fp32), causal mask anchored at the end of the
//   key axis (key c visible to row r iff c <= r + (sk - s)), masked scores
//   NEG_INF = -1e30; online softmax with running max m and sum l;
//   acc = acc * alpha + P . V with P rounded to bf16 before the product;
//   o = acc / l (0 where l == 0), lse = m + log(l) (NEG_INF where l == 0).
//
// What bounds it on this card.  Per (query row, visible key) the work is
// 4 * D flops against 2 * D * 2 bytes of K/V that a block reads once per
// 64 query rows, so at the model's shapes (D = 128, S >= 512) the function
// is compute-bound once K/V stay in shared memory; at short S and small
// batch the q/k/v/o bytes dominate.  The design:
//   - one thread block of 4 warps per (B*N row, tile of 64 query rows);
//     each warp owns 16 query rows and keeps its Q fragment, its scores,
//     its output accumulator and its row statistics in registers;
//   - the TPU's sequential innermost K grid dimension is a loop inside the
//     block over 64-key K/V tiles staged in shared memory; causal blocks
//     stop at the last visible key tile (replaces pl.when(_block_visible));
//   - Q.K^T and P.V run on the tensor cores through mma.sync m16n8k16
//     (bf16 in, fp32 accumulate); the score accumulator's register layout
//     is the A-operand layout of the PV product, so P never leaves
//     registers;
//   - ragged S and Sk are masked per element (replaces _fit_block); keys
//     past Sk are zero-filled in shared memory so no NaN can leak into PV;
//   - GQA reads K/V row bn / (BN / BKV), never a repeated copy;
//   - lse is dense [B*N, S] fp32, not the TPU's 128-lane replicated layout.
// Not done yet (later work): wgmma, TMA, double-buffered K/V tiles, warp
// specialisation.  V is transposed on its way into shared memory so both
// B operands are read as 32-bit pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows per block
constexpr int kBlockN = 64;           // keys per K/V tile
constexpr int kPad = 8;               // bf16 pad per smem row: no bank conflicts
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half (the
// element with the smaller column index in an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int s, int sk, int group, float sm_scale, int causal) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][kBlockN + kPad];  // V^T

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and B-operand column)
  const int t = lane % 4;  // fragment column pair
  const int bn = blockIdx.y;
  const int q_start = blockIdx.x * kBlockM;
  const int offset = sk - s;

  const __nv_bfloat16* q_bn = q + (int64_t)bn * s * D;
  const __nv_bfloat16* k_bn = k + (int64_t)(bn / group) * sk * D;
  const __nv_bfloat16* v_bn = v + (int64_t)(bn / group) * sk * D;

  // this thread's two query rows
  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as A fragments, one per 16-wide slice of D
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = r0 < s ? ld_pair(q_bn + (int64_t)r0 * D + c) : 0u;
    qf[kc][1] = r1 < s ? ld_pair(q_bn + (int64_t)r1 * D + c) : 0u;
    qf[kc][2] = r0 < s ? ld_pair(q_bn + (int64_t)r0 * D + c + 8) : 0u;
    qf[kc][3] = r1 < s ? ld_pair(q_bn + (int64_t)r1 * D + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums

  // last key any row of this block sees, plus one
  const int q_last = min(q_start + kBlockM, s) - 1;
  const int kv_end = causal ? min(sk, q_last + offset + 1) : sk;

  for (int kv_start = 0; kv_start < kv_end; kv_start += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int key = c / kChunks, ch = c % kChunks;
      uint4 kv4 = make_uint4(0, 0, 0, 0);
      if (kv_start + key < sk)
        kv4 = *reinterpret_cast<const uint4*>(k_bn + (int64_t)(kv_start + key) * D + ch * 8);
      *reinterpret_cast<uint4*>(&k_s[key][ch * 8]) = kv4;
    }
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      // keys fastest: a warp's transposed stores hit consecutive addresses
      const int key = c % kBlockN, ch = c / kBlockN;
      uint4 vv4 = make_uint4(0, 0, 0, 0);
      if (kv_start + key < sk)
        vv4 = *reinterpret_cast<const uint4*>(v_bn + (int64_t)(kv_start + key) * D + ch * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[ch * 8 + i][key] = e[i];
    }
    __syncthreads();

    // S = Q . K^T for this warp's 16 rows x 64 keys
    float sc[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kc * 16 + 2 * t];
        mma_16816(sc[nt], qf[kc], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale, mask, row max
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = j < 2 ? r0 : r1;
        const int col = kv_start + nt * 8 + 2 * t + (j & 1);
        const bool visible = col < sk && (!causal || col <= row + offset);
        sc[nt][j] = visible ? sc[nt][j] * sm_scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    // the four threads t = 0..3 of a fragment row hold that row's 64 keys
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(s - m), 0 on masked entries (so a row that sees no key keeps
    // l = 0); row sums from the fp32 P, as on the TPU
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float m = j < 2 ? mn0 : mn1;
        sc[nt][j] = sc[nt][j] > 0.5f * kNegInf ? __expf(sc[nt][j] - m) : 0.f;
      }
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P . V; score tiles 2kc, 2kc+1 form the A fragment of keys
    // 16kc .. 16kc+15
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &vt_s[dt * 8 + g][kc * 16 + 2 * t];
        mma_16816(acc[dt], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }

  // full row sums across the four threads of each row
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float ls0 = l0 == 0.f ? 1.f : l0;  // rows that saw no key -> o = 0
  const float ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  __nv_bfloat16* o_bn = o + (int64_t)bn * s * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<__nv_bfloat162*>(o_bn + (int64_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < s)
      *reinterpret_cast<__nv_bfloat162*>(o_bn + (int64_t)r1 * D + c) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t == 0) {
    if (r0 < s) lse[(int64_t)bn * s + r0] = m0 + logf(ls0);
    if (r1 < s) lse[(int64_t)bn * s + r1] = m1 + logf(ls1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bn, int s, int bkv, int sk, float sm_scale,
                   int causal, cudaStream_t stream) {
  dim3 grid((s + kBlockM - 1) / kBlockM, bn);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      s, sk, bn / bkv, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [bn, s, d], k/v [bkv, sk, d] bf16 contiguous; o [bn, s, d] bf16,
// lse [bn, s] fp32.  Returns the launch's cudaError_t (0 on success).
extern "C" int dlbb_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bn, int s, int bkv,
                                   int sk, int d, float sm_scale, int causal,
                                   void* stream) {
  if (bn <= 0 || s <= 0 || bkv <= 0 || sk <= 0 || bn % bkv != 0 || bn > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return (int)launch<64>(q, k, v, o, l, bn, s, bkv, sk, sm_scale, causal, st);
    case 128:
      return (int)launch<128>(q, k, v, o, l, bn, s, bkv, sk, sm_scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
