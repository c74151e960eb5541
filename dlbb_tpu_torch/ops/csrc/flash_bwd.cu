// Flash attention backward for Hopper (sm_90a): dq, and dk with dv, from
// bf16 q, k, v, dO, fp32 lse and fp32 delta = rowsum(dO * O); bf16 out.
//
// Replaces: dlbb_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the two Pallas TPU kernels of _bwd), computing the same functions:
//   s  = q . k^T * sm_scale (fp32), causal mask anchored at the end of the
//        key axis (key c visible to row r iff c <= r + (sk - s));
//   p  = exp(s - lse) on visible entries, 0 on masked entries and on every
//        row whose lse <= NEG_INF / 2 (a row that saw no key: _p_from_lse);
//   dp = dO . v^T (fp32);  ds = p * (dp - delta) * sm_scale;
//   dq = ds . k           with ds rounded to bf16 first, fp32 accumulation;
//   dv = sum over the g query heads sharing the K/V row of p^T . dO
//                         with p rounded to bf16 first;
//   dk = the same sum of ds^T . q, ds rounded to bf16 first.
// So a row that sees no key gets exactly zero dq and adds nothing to dk/dv.
//
// What bounds it on this card.  Per (query row, visible key) dq does 6 * D
// flops (QK^T, dO V^T, dS K) and dk/dv 8 * D (QK^T recomputed, dO V^T, P^T dO,
// dS^T Q) against q, k, v, dO read once, so at the model's shapes (D = 128,
// S = 512) the pair is near the balance point of bytes and operations and the
// tensor-core issue rate of mma.sync decides.  The design:
//   - dq: one block of 4 warps per (B*N row, 64 query rows); each warp keeps
//     its 16 rows of Q and dO as A fragments, and their lse and delta, in
//     registers, with an fp32 dq accumulator; the TPU's sequential K grid
//     axis is a loop inside the block over 32-key K/V tiles staged in shared
//     memory, stopping at the last tile a causal block sees;
//   - dk/dv: one block of 4 warps per (B*KVH row, 64 keys), each warp owning
//     16 keys with fp32 dk and dv accumulators; the loop runs over the g
//     query heads of the group and, in each, over 32-row Q/dO tiles from the
//     first tile that sees this K tile (the JAX kernel's flattened
//     (group, Q block) inner grid); it computes the transposed scores
//     S^T = K . Q^T and dP^T = V . dO^T, so P^T and dS^T sit in the
//     accumulator layout that the A operand of P^T . dO and dS^T . Q takes;
//   - all products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); a B
//     operand that needs the other layout (K for dS . K, dO and Q for the
//     dk/dv products) is read from the row-major tile as column pairs;
//   - ragged S and Sk are masked per element with zero fill past the end;
//     GQA reads K/V row bn / g, never a repeated copy.
// Not done yet (later work): wgmma, TMA, double-buffered tiles, a fused
// delta preprocess (delta stays one torch expression in the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 pad per smem row: no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr int kDqRows = kWarps * 16;   // query rows per dq block
constexpr int kDqKeys = 32;            // keys per K/V tile of the dq loop
constexpr int kDkvKeys = kWarps * 16;  // keys per dk/dv block
constexpr int kDkvRows = 32;           // query rows per Q/dO tile of the dk/dv loop

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring bf16 of one row
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column: p[0] in the low half, p[stride] in the high half
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of a 16 x 16 bf16 tile of smem rows r0, r0 + 8, cols c, c + 8
// (c = 16 kc + 2 t)
__device__ __forceinline__ void ld_a_frag(uint32_t a[4], const __nv_bfloat16* row0,
                                          const __nv_bfloat16* row1) {
  a[0] = ld_pair(row0);
  a[1] = ld_pair(row1);
  a[2] = ld_pair(row0 + 8);
  a[3] = ld_pair(row1 + 8);
}

// copy rows [row0, row0 + ROWS) of a [nrows, D] bf16 matrix into a padded
// smem tile, 16 bytes per thread per step, zeros past nrows
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16 (*dst)[D + kPad],
                                           const __nv_bfloat16* src, int row0,
                                           int nrows, int tid) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(&dst[r][ch * 8]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int s, int sk, int group,
                    float sm_scale, int causal) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kDqKeys][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kDqKeys][D + kPad];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and B-operand column)
  const int t = lane % 4;  // fragment column pair
  const int bn = blockIdx.y;
  const int q_start = blockIdx.x * kDqRows;
  const int offset = sk - s;

  const __nv_bfloat16* q_bn = q + (int64_t)bn * s * D;
  const __nv_bfloat16* do_bn = dout + (int64_t)bn * s * D;
  const __nv_bfloat16* k_bn = k + (int64_t)(bn / group) * sk * D;
  const __nv_bfloat16* v_bn = v + (int64_t)(bn / group) * sk * D;

  // this thread's two query rows
  const int r0 = q_start + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q and dO as A fragments, one per 16-wide slice of D
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = r0 < s ? ld_pair(q_bn + (int64_t)r0 * D + c) : 0u;
    qf[kc][1] = r1 < s ? ld_pair(q_bn + (int64_t)r1 * D + c) : 0u;
    qf[kc][2] = r0 < s ? ld_pair(q_bn + (int64_t)r0 * D + c + 8) : 0u;
    qf[kc][3] = r1 < s ? ld_pair(q_bn + (int64_t)r1 * D + c + 8) : 0u;
    df[kc][0] = r0 < s ? ld_pair(do_bn + (int64_t)r0 * D + c) : 0u;
    df[kc][1] = r1 < s ? ld_pair(do_bn + (int64_t)r1 * D + c) : 0u;
    df[kc][2] = r0 < s ? ld_pair(do_bn + (int64_t)r0 * D + c + 8) : 0u;
    df[kc][3] = r1 < s ? ld_pair(do_bn + (int64_t)r1 * D + c + 8) : 0u;
  }
  const float lse0 = r0 < s ? lse[(int64_t)bn * s + r0] : kNegInf;
  const float lse1 = r1 < s ? lse[(int64_t)bn * s + r1] : kNegInf;
  const float dl0 = r0 < s ? delta[(int64_t)bn * s + r0] : 0.f;
  const float dl1 = r1 < s ? delta[(int64_t)bn * s + r1] : 0.f;
  // rows past s and rows that saw no key in the forward get p = 0
  const bool live0 = lse0 > 0.5f * kNegInf;
  const bool live1 = lse1 > 0.5f * kNegInf;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // last key any row of this block sees, plus one
  const int q_last = min(q_start + kDqRows, s) - 1;
  const int kv_end = causal ? min(sk, q_last + offset + 1) : sk;

  for (int kv_start = 0; kv_start < kv_end; kv_start += kDqKeys) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D, kDqKeys>(k_s, k_bn, kv_start, sk, tid);
    stage_rows<D, kDqKeys>(v_s, v_bn, kv_start, sk, tid);
    __syncthreads();

    // S = Q . K^T and dP = dO . V^T for this warp's 16 rows x 32 keys
    float sc[kDqKeys / 8][4], dp[kDqKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kDqKeys / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kDqKeys / 8; ++nt) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kc * 16 + 2 * t];
        mma_16816(sc[nt], qf[kc], ld_pair(kr), ld_pair(kr + 8));
        const __nv_bfloat16* vr = &v_s[nt * 8 + g][kc * 16 + 2 * t];
        mma_16816(dp[nt], df[kc], ld_pair(vr), ld_pair(vr + 8));
      }
    }

    // P = exp(S * scale - lse) on visible entries, 0 elsewhere;
    // dS = P * (dP - delta) * scale, kept in sc
#pragma unroll
    for (int nt = 0; nt < kDqKeys / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool upper = j < 2;
        const int row = upper ? r0 : r1;
        const int col = kv_start + nt * 8 + 2 * t + (j & 1);
        const bool visible = (upper ? live0 : live1) && col < sk &&
                             (!causal || col <= row + offset);
        const float p = visible ? __expf(sc[nt][j] * sm_scale - (upper ? lse0 : lse1)) : 0.f;
        sc[nt][j] = p * (dp[nt][j] - (upper ? dl0 : dl1)) * sm_scale;
      }
    }

    // dQ += dS . K: score tiles 2kc, 2kc+1 are the A fragment of keys
    // 16kc .. 16kc+15 (dS rounded to bf16); K read as column pairs
#pragma unroll
    for (int kc = 0; kc < kDqKeys / 16; ++kc) {
      uint32_t sa[4];
      sa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      sa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      sa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      sa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* kp = &k_s[kc * 16 + 2 * t][dt * 8 + g];
        mma_16816(acc[dt], sa, ld_col_pair(kp, D + kPad),
                  ld_col_pair(kp + 8 * (D + kPad), D + kPad));
      }
    }
  }

  __nv_bfloat16* dq_bn = dq + (int64_t)bn * s * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < s)
      *reinterpret_cast<__nv_bfloat162*>(dq_bn + (int64_t)r0 * D + c) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    if (r1 < s)
      *reinterpret_cast<__nv_bfloat162*>(dq_bn + (int64_t)r1 * D + c) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kDkvKeys + 2 * kDkvRows) * (D + kPad) * (int)sizeof(__nv_bfloat16) +
         2 * kDkvRows * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int s, int sk, int group, float sm_scale, int causal) {
  // K and V tiles of this block, then one Q/dO tile with its lse and delta
  extern __shared__ __align__(16) unsigned char smem[];
  using Row = __nv_bfloat16[D + kPad];
  Row* k_s = reinterpret_cast<Row*>(smem);
  Row* v_s = k_s + kDkvKeys;
  Row* q_s = v_s + kDkvKeys;
  Row* do_s = q_s + kDkvRows;
  float* lse_s = reinterpret_cast<float*>(do_s + kDkvRows);
  float* dl_s = lse_s + kDkvRows;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bkv = blockIdx.y;
  const int k_start = blockIdx.x * kDkvKeys;
  const int offset = sk - s;

  const __nv_bfloat16* k_b = k + (int64_t)bkv * sk * D;
  const __nv_bfloat16* v_b = v + (int64_t)bkv * sk * D;
  stage_rows<D, kDkvKeys>(k_s, k_b, k_start, sk, tid);
  stage_rows<D, kDkvKeys>(v_s, v_b, k_start, sk, tid);

  // this thread's two keys: rows kr0, kr1 of the tile
  const int kr0 = warp * 16 + g;
  const int kr1 = kr0 + 8;
  const int key0 = k_start + kr0;
  const int key1 = k_start + kr1;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  // the first Q tile holding a row that sees a key of this tile
  int q_begin = causal ? max(0, k_start - offset) : 0;
  q_begin = (q_begin / kDkvRows) * kDkvRows;

  for (int h = 0; h < group; ++h) {
    const int bn = bkv * group + h;
    const __nv_bfloat16* q_bn = q + (int64_t)bn * s * D;
    const __nv_bfloat16* do_bn = dout + (int64_t)bn * s * D;
    const float* lse_bn = lse + (int64_t)bn * s;
    const float* dl_bn = delta + (int64_t)bn * s;

    for (int q_start = q_begin; q_start < s; q_start += kDkvRows) {
      __syncthreads();  // every warp is done with the previous Q/dO tile
      stage_rows<D, kDkvRows>(q_s, q_bn, q_start, s, tid);
      stage_rows<D, kDkvRows>(do_s, do_bn, q_start, s, tid);
      for (int i = tid; i < kDkvRows; i += kThreads) {
        const int r = q_start + i;
        lse_s[i] = r < s ? lse_bn[r] : kNegInf;
        dl_s[i] = r < s ? dl_bn[r] : 0.f;
      }
      __syncthreads();

      // S^T = K . Q^T and dP^T = V . dO^T: this warp's 16 keys x 32 rows
      float st[kDkvRows / 8][4], dpt[kDkvRows / 8][4];
#pragma unroll
      for (int nt = 0; nt < kDkvRows / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ka[4], va[4];
        ld_a_frag(ka, &k_s[kr0][kc * 16 + 2 * t], &k_s[kr1][kc * 16 + 2 * t]);
        ld_a_frag(va, &v_s[kr0][kc * 16 + 2 * t], &v_s[kr1][kc * 16 + 2 * t]);
#pragma unroll
        for (int nt = 0; nt < kDkvRows / 8; ++nt) {
          const __nv_bfloat16* qr = &q_s[nt * 8 + g][kc * 16 + 2 * t];
          mma_16816(st[nt], ka, ld_pair(qr), ld_pair(qr + 8));
          const __nv_bfloat16* dr = &do_s[nt * 8 + g][kc * 16 + 2 * t];
          mma_16816(dpt[nt], va, ld_pair(dr), ld_pair(dr + 8));
        }
      }

      // P^T = exp(S^T * scale - lse) on visible entries, 0 elsewhere (kept
      // in st); dS^T = P^T * (dP^T - delta) * scale (kept in dpt)
#pragma unroll
      for (int nt = 0; nt < kDkvRows / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = j < 2 ? key0 : key1;
          const int cl = nt * 8 + 2 * t + (j & 1);
          const int row = q_start + cl;
          const float lse_r = lse_s[cl];
          const bool visible = row < s && key < sk && lse_r > 0.5f * kNegInf &&
                               (!causal || key <= row + offset);
          const float p = visible ? __expf(st[nt][j] * sm_scale - lse_r) : 0.f;
          st[nt][j] = p;
          dpt[nt][j] = p * (dpt[nt][j] - dl_s[cl]) * sm_scale;
        }
      }

      // dV += P^T . dO and dK += dS^T . Q: tiles 2kc, 2kc+1 are the A
      // fragment of query rows 16kc .. 16kc+15 (rounded to bf16); dO and Q
      // read as column pairs
#pragma unroll
      for (int kc = 0; kc < kDkvRows / 16; ++kc) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(st[2 * kc][0], st[2 * kc][1]);
        pa[1] = pack_bf16(st[2 * kc][2], st[2 * kc][3]);
        pa[2] = pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]);
        pa[3] = pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3]);
        sa[0] = pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]);
        sa[1] = pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]);
        sa[2] = pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
        sa[3] = pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const __nv_bfloat16* dop = &do_s[kc * 16 + 2 * t][dt * 8 + g];
          mma_16816(dva[dt], pa, ld_col_pair(dop, D + kPad),
                    ld_col_pair(dop + 8 * (D + kPad), D + kPad));
          const __nv_bfloat16* qp = &q_s[kc * 16 + 2 * t][dt * 8 + g];
          mma_16816(dka[dt], sa, ld_col_pair(qp, D + kPad),
                    ld_col_pair(qp + 8 * (D + kPad), D + kPad));
        }
      }
    }
  }

  __nv_bfloat16* dk_b = dk + (int64_t)bkv * sk * D;
  __nv_bfloat16* dv_b = dv + (int64_t)bkv * sk * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (key0 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk_b + (int64_t)key0 * D + c) =
          __floats2bfloat162_rn(dka[dt][0], dka[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_b + (int64_t)key0 * D + c) =
          __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dk_b + (int64_t)key1 * D + c) =
          __floats2bfloat162_rn(dka[dt][2], dka[dt][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv_b + (int64_t)key1 * D + c) =
          __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
    }
  }
}

bool bad_sizes(int bn, int s, int bkv, int sk) {
  return bn <= 0 || s <= 0 || bkv <= 0 || sk <= 0 || bn % bkv != 0 || bn > 65535;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bn, int s,
                      int bkv, int sk, float sm_scale, int causal, cudaStream_t stream) {
  dim3 grid((s + kDqRows - 1) / kDqRows, bn);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, static_cast<__nv_bfloat16*>(dq), s, sk, bn / bkv, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int bn, int s, int bkv, int sk, float sm_scale, int causal,
                       cudaStream_t stream) {
  constexpr int kSmem = dkv_smem_bytes<D>();
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kDkvKeys - 1) / kDkvKeys, bkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      s, sk, bn / bkv, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, dout [bn, s, d], k/v [bkv, sk, d] bf16 contiguous; lse, delta [bn, s]
// fp32; dq [bn, s, d] bf16.  Returns the launch's cudaError_t (0 on success).
extern "C" int dlbb_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, int bn, int s,
                                      int bkv, int sk, int d, float sm_scale,
                                      int causal, void* stream) {
  if (bad_sizes(bn, s, bkv, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 64:
      return (int)launch_dq<64>(q, k, v, dout, l, dl, dq, bn, s, bkv, sk, sm_scale, causal, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, l, dl, dq, bn, s, bkv, sk, sm_scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the same inputs; dk, dv [bkv, sk, d] bf16, each summed over the bn / bkv
// query heads that share a K/V row
extern "C" int dlbb_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int bn,
                                       int s, int bkv, int sk, int d, float sm_scale,
                                       int causal, void* stream) {
  if (bad_sizes(bn, s, bkv, sk) || bkv > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 64:
      return (int)launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, bn, s, bkv, sk, sm_scale,
                                 causal, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, bn, s, bkv, sk, sm_scale,
                                  causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
