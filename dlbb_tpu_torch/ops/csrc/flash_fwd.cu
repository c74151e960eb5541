// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out + fp32 lse.
//
// Replaces: dlbb_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel), computing the same function:
//   s = q . k^T * sm_scale (fp32), causal mask anchored at the end of the
//   key axis (key c visible to row r iff c <= r + (sk - s)); online softmax
//   with running max m and sum l; acc = acc * alpha + P . V with P rounded
//   to bf16 before the product; o = acc / l (0 where l == 0),
//   lse = m + log(l) (NEG_INF = -1e30 where l == 0).  A masked entry never
//   enters the sums (p = 0), so a row that sees no key keeps l = 0 at any
//   tiling.
//
// What bounds it on this card.  Per (query row, visible key) the work is
// 4 * D flops; q, k, v and o are read or written once.  At the model's
// shape (B=8, N=16, S=512, D=128) the bytes bound it (0.02 ms), at S=8192
// the tensor cores do (0.28 ms).  The design, after FlashAttention-3:
//   - one block of three warpgroups per (B*N row, 128 query rows); blocks
//     are numbered heaviest causal Q block first, all B*N rows in
//     blockIdx.x (no 65535 cap);
//   - warpgroup 0, the producer, gives its registers away (setmaxnreg) and
//     one of its threads issues every TMA load: the Q tile once, then the
//     K and V tiles (128 keys x D) into two rings of kStages stages, K one
//     tile ahead of V, each stage guarded by a "full" mbarrier (TMA bytes
//     landed) and an "empty" one (every consumer warp done with it);
//   - warpgroups 1 and 2, the consumers, own 64 query rows each:
//     S = Q.K^T by wgmma with both operands K-major in shared memory,
//     softmax in registers in the log2 domain (exp2 with scale * log2(e)
//     folded in), then O += P.V by wgmma with P from registers (the S
//     accumulator packed to bf16 is the A fragment) and V read MN-major
//     straight from its TMA tile with the transpose bit: no V transpose
//     pass and no shared-memory round trip for P.  Inside a consumer the
//     Q.K^T of tile i + 1 is issued before the P.V of tile i, and the
//     softmax of tile i + 1 runs while that P.V is on the tensor cores;
//   - K tiles are visited from the last visible one down; only the tiles
//     that cross the causal diagonal or sk take the per-element mask
//     (fwd_tile_plan in ops/flash_attention.py is the same rule in Python);
//   - Q, K, V and O are 3-D tensor maps (D, S, B*N): a ragged tail reads
//     zeros and stores nothing past its own head's rows.  O goes back
//     through the consumer's own rows of the Q tile and a TMA store;
//   - GQA reads K/V plane bn / g, never a repeated copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block: two consumers x 64
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kStages = 2;
  static constexpr int kSlabs = D / 64;            // 64-column slabs per row
  static constexpr int kSlabQ = kBlockM * 128;     // bytes of one Q slab
  static constexpr int kSlabKV = kBlockN * 128;    // bytes of one K or V slab
  static constexpr int kQBytes = kSlabs * kSlabQ;
  static constexpr int kKVBytes = kSlabs * kSlabKV;  // one K (or V) tile
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kBars = 1 + 4 * kStages;  // q_full, k/v full[], k/v empty[]
  static constexpr int kSmemBytes = kOffBar + 8 * kBars + 1024;  // + alignment slack
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q . K^T for one consumer's 64 rows x 128 keys, D / 16 steps of k16;
// Q and K are both K-major (row-major [rows, D]) in 64-column slabs
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows, uint32_t k_tile) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_off = (kk / 4) * C::kSlabQ + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * C::kSlabKV + (kk % 4) * 32;
    hopper::wgmma_m64n128k16_ss<0>(sc, hopper::desc_sw128(q_rows + q_off, 16, 1024),
                                   hopper::desc_sw128(k_tile + k_off, 16, 1024), kk > 0);
  }
}

// O += P . V: P from registers, V [keys, D] read MN-major (transpose bit),
// 16 keys (2048 bytes of every slab) per step, slabs kSlabKV apart
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t desc = hopper::desc_sw128(v_tile + kk * 16 * 128, Cfg<D>::kSlabKV, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs<1>(o, pa[kk], desc, 1);
    else
      hopper::wgmma_m64n64k16_rs<1>(o, pa[kk], desc, 1);
  }
}

// One tile's mask and online-softmax step, in place: scores in, fp32 p out.
// Accumulator layout: sc[4j + e] is (row0, key col0 + 8j + e), sc[4j + 2 + e]
// is (row1, the same key), col0 = first key of the tile + 2t; the four
// threads t = 0..3 of a row hold its 128 keys.
struct RowState {
  float m0, m1;  // running max, raw score units (-inf until a key is seen)
  float l0, l1;  // this thread's share of the running sums
};

__device__ __forceinline__ void softmax_tile(float (&sc)[64], RowState& rs, bool mask, int col0,
                                             int row0, int row1, int sk, int causal, int offset,
                                             float c, float& alpha0, float& alpha1) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        if (!(col < sk && (!causal || col <= row0 + offset))) sc[4 * j + e] = -INFINITY;
        if (!(col < sk && (!causal || col <= row1 + offset))) sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  float mx0 = rs.m0, mx1 = rs.m1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  // a row with nothing visible yet keeps max -inf: subtract 0 there so
  // exp2(-inf) gives p = 0 and alpha = 0, never a NaN
  const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * c;
  const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * c;
  alpha0 = ex2(rs.m0 * c - ms0);
  alpha1 = ex2(rs.m1 * c - ms1);
  rs.m0 = mx0;
  rs.m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], c, -ms0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], c, -ms0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], c, -ms1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], c, -ms1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  rs.l0 = rs.l0 * alpha0 + sum0;  // row sums from the fp32 p, as on the TPU
  rs.l1 = rs.l1 * alpha1 + sum1;
}

// p rounded to bf16: score blocks 2kk and 2kk + 1 are the A fragment of
// keys 16kk .. 16kk + 15
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int bn_total, int s, int sk, int group,
                 float sm_scale, int causal, int q_blocks) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + C::kOffK, sV = base + C::kOffV;
  const uint32_t q_full = base + C::kOffBar;
  auto k_full = [&](int st) { return q_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (1 + S + st); };
  auto k_empty = [&](int st) { return q_full + 8u * (1 + 2 * S + st); };
  auto v_empty = [&](int st) { return q_full + 8u * (1 + 3 * S + st); };

  const int bn = blockIdx.x % bn_total;
  const int qb = q_blocks - 1 - static_cast<int>(blockIdx.x / bn_total);  // heaviest first
  const int q_start = qb * kBlockM;
  const int offset = sk - s;

  // the tile plan (fwd_tile_plan): K tiles [0, n_vis) are visited, from the
  // last down (visit it is tile n_vis - 1 - it); tiles from n_full up take
  // the per-element mask
  const int q_last = min(q_start + kBlockM, s) - 1;
  const int kv_end = causal ? min(sk, q_last + offset + 1) : sk;
  const int n_vis = kv_end > 0 ? (kv_end + kBlockN - 1) / kBlockN : 0;
  int n_full = sk / kBlockN;
  if (causal) n_full = min(n_full, max(0, q_start + offset + 1) / kBlockN);
  n_full = min(n_full, n_vis);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), kConsumerWarps);
      hopper::mbar_init(v_empty(st), kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    // K runs one tile ahead of V: the consumers' Q.K^T of tile it + 1
    // overlaps their P.V of tile it
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_desc(&tq);
      hopper::tma_prefetch_desc(&tk);
      hopper::tma_prefetch_desc(&tv);
      hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int j = 0; j < C::kSlabs; ++j)
        hopper::tma_load_3d(sQ + j * C::kSlabQ, &tq, q_full, 64 * j, q_start, bn);
      const int kv_plane = bn / group;
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty,
                      int it) {
        if (it >= S) hopper::mbar_wait(empty, ((it / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(full, C::kKVBytes);
#pragma unroll
        for (int j = 0; j < C::kSlabs; ++j)
          hopper::tma_load_3d(ring + (it % S) * C::kKVBytes + j * C::kSlabKV, map, full, 64 * j,
                              (n_vis - 1 - it) * kBlockN, kv_plane);
      };
      for (int it = 0; it < n_vis; ++it) {
        load(&tk, sK, k_full(it % S), k_empty(it % S), it);
        if (it > 0) load(&tv, sV, v_full((it - 1) % S), v_empty((it - 1) % S), it - 1);
      }
      if (n_vis > 0) load(&tv, sV, v_full((n_vis - 1) % S), v_empty((n_vis - 1) % S), n_vis - 1);
    }
  } else {
    // ---------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cwg = threadIdx.x / 128 - 1;  // 0 or 1: rows 64 * cwg ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_local = warp * 16 + g;  // this thread's rows: r_local, r_local + 8
    const int row0 = q_start + cwg * 64 + r_local, row1 = row0 + 8;
    const float c = sm_scale * kLog2e;
    const uint32_t q_rows = sQ + cwg * 64 * 128;  // this consumer's rows of each Q slab

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    RowState rs{-INFINITY, -INFINITY, 0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    if (n_vis > 0) {
      float sc[64];
      uint32_t pa[8][4];
      float alpha0, alpha1;
      // visit 0: S, softmax, P
      hopper::mbar_wait(k_full(0), 0);
      hopper::wgmma_fence();
      issue_qk<D>(sc, q_rows, sK);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (lane == 0) hopper::mbar_arrive(k_empty(0));
      softmax_tile(sc, rs, n_vis - 1 >= n_full, (n_vis - 1) * kBlockN + 2 * t, row0, row1, sk,
                   causal, offset, c, alpha0, alpha1);
      pack_p(pa, sc);
      // visit it: S of tile it on the tensor cores while P.V of tile it - 1
      // is queued behind it; the softmax of tile it runs under that P.V
      for (int it = 1; it < n_vis; ++it) {
        const int st = it % S, pst = (it - 1) % S;
        const int n = n_vis - 1 - it;
        hopper::mbar_wait(k_full(st), (it / S) & 1);
        hopper::mbar_wait(v_full(pst), ((it - 1) / S) & 1);
        hopper::wgmma_fence();
        issue_qk<D>(sc, q_rows, sK + st * C::kKVBytes);
        hopper::wgmma_commit();
        issue_pv<D>(o, pa, sV + pst * C::kKVBytes);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S is done (groups complete in order)
        hopper::fence_regs(sc);
        if (lane == 0) hopper::mbar_arrive(k_empty(st));
        softmax_tile(sc, rs, n >= n_full, n * kBlockN + 2 * t, row0, row1, sk, causal, offset,
                     c, alpha0, alpha1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) hopper::fence_regs(pa[kk]);
        if (lane == 0) hopper::mbar_arrive(v_empty(pst));
        rescale(o, alpha0, alpha1);
        pack_p(pa, sc);
      }
      const int lst = (n_vis - 1) % S;
      hopper::mbar_wait(v_full(lst), ((n_vis - 1) / S) & 1);
      hopper::wgmma_fence();
      issue_pv<D>(o, pa, sV + lst * C::kKVBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) hopper::fence_regs(pa[kk]);
    }
    float l0 = rs.l0, l1 = rs.l1;
    const float m0 = rs.m0, m1 = rs.m1;

    // full row sums across the four threads of each row
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    if (t == 0) {
      if (row0 < s) lse[(int64_t)bn * s + row0] = l0 > 0.f ? m0 * sm_scale + logf(l0) : kNegInf;
      if (row1 < s) lse[(int64_t)bn * s + row1] = l1 > 0.f ? m1 * sm_scale + logf(l1) : kNegInf;
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // rows that saw no key -> o = 0
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;

    // O -> this consumer's rows of the Q tile (swizzled as TMA wants it),
    // then one TMA store per slab; rows past s are clipped by the map
    hopper::named_barrier_sync(1 + cwg, 128);  // every warp is done reading Q
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t slab = q_rows + (j / 8) * C::kSlabQ;
      const uint32_t chunk = ((j % 8) ^ g) * 16 + 4 * t;  // (r_local + 8) % 8 == g too
      *reinterpret_cast<uint32_t*>(smem + (slab - base) + r_local * 128 + chunk) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(smem + (slab - base) + (r_local + 8) * 128 + chunk) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    hopper::fence_proxy_async_smem();
    hopper::named_barrier_sync(1 + cwg, 128);
    if (tid == 0 && q_start + cwg * 64 < s) {
#pragma unroll
      for (int j = 0; j < C::kSlabs; ++j)
        hopper::tma_store_3d(&to, q_rows + j * C::kSlabQ, 64 * j, q_start + cwg * 64, bn);
      hopper::tma_store_commit_and_wait();
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bn,
                   int s, int bkv, int sk, float sm_scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = hopper::make_tmap_bf16_3d(&tq, q, D, s, bn, kBlockM)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&tk, k, D, sk, bkv, kBlockN)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&tv, v, D, sk, bkv, kBlockN)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&to, o, D, s, bn, 64)) != cudaSuccess) return err;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int q_blocks = (s + kBlockM - 1) / kBlockM;
  const long long blocks = static_cast<long long>(q_blocks) * bn;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<D><<<static_cast<unsigned>(blocks), kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, to, lse, bn, s, sk, bn / bkv, sm_scale, causal, q_blocks);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q [bn, s, d], k/v [bkv, sk, d] bf16 contiguous, 16-byte aligned (TMA);
// o [bn, s, d] bf16, lse [bn, s] fp32.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int dlbb_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bn, int s, int bkv, int sk, int d,
                                   float sm_scale, int causal, void* stream) {
  if (bn <= 0 || s <= 0 || bkv <= 0 || sk <= 0 || bn % bkv != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
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
