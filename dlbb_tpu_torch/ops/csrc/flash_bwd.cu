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
// No atomics: every output element is summed inside one block, in a fixed
// order, so the results are the same bits from run to run.
//
// What bounds it on this card.  Per (query row, visible key) dq does 6 * D
// flops (Q.K^T, dO.V^T, dS.K) and dk/dv 8 * D (Q.K^T again, dO.V^T, P^T.dO,
// dS^T.Q) against q, k, v, dO read once: at the model's shape (B=8, N=16,
// S=512, D=128) the bytes bound both (0.025 and 0.030 ms), at S=8192 the
// tensor cores (0.42 and 0.56 ms).  Two kernels, as on the TPU, rather than
// one with dq summed by atomics: the price is the recomputed Q.K^T and
// dO.V^T (14 * D flops per pair for the pair instead of 10 * D).  Both are
// built like the forward (flash_fwd.cu) on the pieces of hopper.cuh:
//   - one block of three warpgroups; warpgroup 0, the producer, gives its
//     registers away (setmaxnreg) and one of its threads issues every TMA
//     load into mbarrier rings ("full": bytes landed, "empty": every
//     consumer warp done); warpgroups 1 and 2, the consumers, run wgmma;
//   - every tensor is a 3-D tensor map (D, S, planes) with 64-row boxes of
//     64-column slabs and the 128-byte swizzle: a ragged tail reads zeros and
//     a store writes nothing past its own head's rows;
//   - all rows are in blockIdx.x (no 65535 cap on B*N), heaviest causal
//     tile first;
//   - results leave through shared memory and a TMA store.
// dq (_dq_kernel): one block per (B*N row, 128 query rows); the producer
// loads the Q and dO tiles once, then 64-key K and V tiles (plane bn / g)
// into a 3-stage ring, up to the last tile the block sees.  Each consumer
// owns 64 query rows with their lse and delta in registers, and per tile
// runs S = Q.K^T and dP = dO.V^T (wgmma, both operands K-major in shared
// memory), P = exp2(S * scale * log2e - lse * log2e) and dS in registers,
// then dq += dS.K with dS packed to bf16 as the A fragment and K read
// MN-major through the transpose bit (the forward's P.V with K for V); the
// next tile's S and dP are issued before the wait on this dS.K.
// dk/dv (_dkv_kernel): one block per (B*KVH row, 128 keys); K and V are
// loaded once; the loop runs over the g query heads of the group and, in
// each, over 64-row Q tiles from the first that sees the block's keys (the
// TPU's flattened (group, Q block) grid axis).  The producer's warp fills
// a 3-stage ring of Q and dO tiles and, beside each, its 64 rows' lse (in
// log2 units, +inf for rows that give p = 0) and delta, which the warp's
// lanes read with plain loads (fp32 rows of S = 130 do not suit TMA).
// Each consumer owns 64 keys and runs S^T = K.Q^T and dP^T = V.dO^T, then
// dv += P^T.dO and dk += dS^T.Q with P^T and dS^T packed to bf16 from
// registers and dO and Q read MN-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kDqBlockM = 128;   // query rows per dq block: two consumers x 64
constexpr int kDqBlockN = 64;    // keys per K/V tile of the dq loop
constexpr int kDkvBlockN = 128;  // keys per dk/dv block: two consumers x 64
constexpr int kDkvBlockM = 64;   // query rows per Q/dO tile of the dk/dv loop
constexpr int kDqStages = 3;     // depth of the dq kernel's K/V ring
constexpr int kDkvStages = 3;    // depth of the dk/dv kernel's Q/dO ring
constexpr int kBox = 64;         // rows per TMA box
constexpr int kBoxBytes = kBox * 128;  // one box of one 64-column slab
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the dq kernel: the Q and dO tiles, then rings of K and
// V tiles, then the barriers.
template <int D>
struct DqCfg {
  static constexpr int kSlabs = D / 64;
  static constexpr int kSlabQ = kDqBlockM * 128;   // bytes of one Q (or dO) slab
  static constexpr int kSlabKV = kDqBlockN * 128;  // bytes of one K (or V) slab
  static constexpr int kQBytes = kSlabs * kSlabQ;
  static constexpr int kKVBytes = kSlabs * kSlabKV;
  static constexpr int kOffDo = kQBytes;
  static constexpr int kOffK = 2 * kQBytes;
  static constexpr int kOffV = kOffK + kDqStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kDqStages * kKVBytes;
  static constexpr int kBars = 1 + 2 * kDqStages;  // q_full, full[], empty[]
  static constexpr int kSmemBytes = kOffBar + 8 * kBars + 1024;  // + alignment slack
};

// Shared memory of the dk/dv kernel: the K and V tiles, then rings of Q and
// dO tiles and of their rows' lse and delta, then the barriers.
template <int D>
struct DkvCfg {
  static constexpr int kSlabs = D / 64;
  static constexpr int kSlabKV = kDkvBlockN * 128;
  static constexpr int kSlabQ = kDkvBlockM * 128;
  static constexpr int kKVBytes = kSlabs * kSlabKV;
  static constexpr int kQBytes = kSlabs * kSlabQ;
  static constexpr int kOffV = kKVBytes;
  static constexpr int kOffQ = 2 * kKVBytes;
  static constexpr int kOffDo = kOffQ + kDkvStages * kQBytes;
  static constexpr int kOffRows = kOffDo + kDkvStages * kQBytes;  // [stage][lse, delta][64] fp32
  static constexpr int kOffBar = kOffRows + kDkvStages * 2 * kDkvBlockM * 4;
  static constexpr int kBars = 1 + 2 * kDkvStages;  // kv_full, full[], empty[]
  static constexpr int kSmemBytes = kOffBar + 8 * kBars + 1024;
};

// acc[64 x 64] = A[64 rows, D] . B[64 rows, D]^T, both K-major in 64-column
// slabs (slab_a and slab_b bytes apart): D / 16 steps of k16, each moving 32
// bytes along the 128-byte rows
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a, uint32_t slab_a,
                                          uint32_t b, uint32_t slab_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a_off = (kk / 4) * slab_a + (kk % 4) * 32;
    const uint32_t b_off = (kk / 4) * slab_b + (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss<0>(acc, hopper::desc_sw128(a + a_off, 16, 1024),
                                  hopper::desc_sw128(b + b_off, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += A[64 x 64] . B[64 rows, D]: A from registers (the bf16
// fragments of an accumulator), B read MN-major through the transpose bit,
// 16 rows (2048 bytes of every slab) per step, slabs slab_b bytes apart
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                         uint32_t b, uint32_t slab_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = hopper::desc_sw128(b + kk * 16 * 128, slab_b, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs<1>(acc, a[kk], desc, 1);
    else
      hopper::wgmma_m64n64k16_rs<1>(acc, a[kk], desc, 1);
  }
}

// One consumer's accumulator (fp32, rows r_local and r_local + 8 of its 64)
// -> bf16 into its 64 rows of a tile in shared memory, swizzled as TMA reads
// it; then one TMA store per slab of those rows at (row0, plane).  Rows past
// the map's extent are not written.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], uint8_t* smem, uint32_t base,
                                           uint32_t rows, uint32_t slab, const CUtensorMap* map,
                                           int row0, int plane, int extent, int cwg, int tid) {
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r_local = (tid / 32) * 16 + g;
  hopper::named_barrier_sync(1 + cwg, 128);  // every warp of this consumer is done with `rows`
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t s0 = rows - base + (j / 8) * slab;
    const uint32_t chunk = ((j % 8) ^ g) * 16 + 4 * t;  // (r_local + 8) % 8 == g too
    *reinterpret_cast<uint32_t*>(smem + s0 + r_local * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(smem + s0 + (r_local + 8) * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::fence_proxy_async_smem();
  hopper::named_barrier_sync(1 + cwg, 128);
  if (tid == 0 && row0 < extent) {
#pragma unroll
    for (int j = 0; j < D / 64; ++j) hopper::tma_store_3d(map, rows + j * slab, 64 * j, row0, plane);
    hopper::tma_store_commit_and_wait();
  }
}

// dS = P * (dP - delta) * scale of one K tile for the rows row0, row1 of
// this thread, from the S and dP accumulators (sc[4j + e] is (row0, key
// col0 + 8j + e), sc[4j + 2 + e] is (row1, the same key), col0 = the tile's
// first key + 2t), rounded to bf16 as the A fragments of dS.K.  lse0, lse1
// are in log2 units, +inf where p must be 0.
struct DqRows {
  int row0, row1;
  float lse0, lse1, dl0, dl1;
};

__device__ __forceinline__ void ds_frags(uint32_t (&da)[4][4], float (&sc)[32],
                                         const float (&dp)[32], const DqRows& r, bool mask,
                                         int col0, int sk, int causal, int offset, float c,
                                         float sm_scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      float p0 = hopper::ex2(fmaf(sc[4 * j + e], c, -r.lse0));
      float p1 = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -r.lse1));
      if (mask) {
        if (!(col < sk && (!causal || col <= r.row0 + offset))) p0 = 0.f;
        if (!(col < sk && (!causal || col <= r.row1 + offset))) p1 = 0.f;
      }
      sc[4 * j + e] = p0 * (dp[4 * j + e] - r.dl0) * sm_scale;
      sc[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - r.dl1) * sm_scale;
    }
  }
  hopper::acc_to_a_frags<64>(da, sc);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int bn_total, int s, int sk, int group,
                    float sm_scale, int causal, int q_blocks) {
  using C = DqCfg<D>;
  constexpr int S = kDqStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sDo = base + C::kOffDo, sK = base + C::kOffK, sV = base + C::kOffV;
  const uint32_t q_full = base + C::kOffBar;
  auto full = [&](int st) { return q_full + 8u * (1 + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + S + st); };

  const int bn = blockIdx.x % bn_total;
  const int qb = q_blocks - 1 - static_cast<int>(blockIdx.x / bn_total);  // heaviest first
  const int q_start = qb * kDqBlockM;
  const int offset = sk - s;
  // K tiles [0, n_vis) hold a key some row of the block sees; tiles from
  // n_full up cross the causal diagonal or sk and take the per-element mask
  const int q_last = min(q_start + kDqBlockM, s) - 1;
  const int kv_end = causal ? min(sk, q_last + offset + 1) : sk;
  const int n_vis = kv_end > 0 ? (kv_end + kDqBlockN - 1) / kDqBlockN : 0;
  int n_full = sk / kDqBlockN;
  if (causal) n_full = min(n_full, max(0, q_start + offset + 1) / kDqBlockN);
  n_full = min(n_full, n_vis);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_desc(&tq);
      hopper::tma_prefetch_desc(&tdo);
      hopper::tma_prefetch_desc(&tk);
      hopper::tma_prefetch_desc(&tv);
      // Q and dO: the boxes of 64 rows that start inside s (rows past s of
      // a box read zeros; a box wholly past s is left unloaded, and only
      // its own rows, which are not stored, ever read it)
      const int boxes = min(kDqBlockM / kBox, (s - q_start + kBox - 1) / kBox);
      hopper::mbar_arrive_expect_tx(q_full, 2 * boxes * C::kSlabs * kBoxBytes);
      for (int j = 0; j < C::kSlabs; ++j) {
        for (int h = 0; h < boxes; ++h) {
          const uint32_t off = j * C::kSlabQ + h * kBoxBytes;
          hopper::tma_load_3d(sQ + off, &tq, q_full, 64 * j, q_start + h * kBox, bn);
          hopper::tma_load_3d(sDo + off, &tdo, q_full, 64 * j, q_start + h * kBox, bn);
        }
      }
      const int kv_plane = bn / group;
      for (int it = 0; it < n_vis; ++it) {
        const int st = it % S;
        if (it >= S) hopper::mbar_wait(empty(st), ((it / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(full(st), 2 * C::kKVBytes);
        for (int j = 0; j < C::kSlabs; ++j) {
          const uint32_t off = st * C::kKVBytes + j * C::kSlabKV;
          hopper::tma_load_3d(sK + off, &tk, full(st), 64 * j, it * kDqBlockN, kv_plane);
          hopper::tma_load_3d(sV + off, &tv, full(st), 64 * j, it * kDqBlockN, kv_plane);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cwg = threadIdx.x / 128 - 1;  // 0 or 1: rows 64 * cwg ..
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q_start + cwg * 64 + (tid / 32) * 16 + g;
    const float c = sm_scale * kLog2e;
    // lse in log2 units, +inf where p must be 0 (rows past s, rows that saw
    // no key): exp2(x - inf) = 0
    DqRows r{row0, row0 + 8, INFINITY, INFINITY, 0.f, 0.f};
    if (r.row0 < s) {
      const float l = lse[(int64_t)bn * s + r.row0];
      r.lse0 = l > 0.5f * kNegInf ? l * kLog2e : INFINITY;
      r.dl0 = delta[(int64_t)bn * s + r.row0];
    }
    if (r.row1 < s) {
      const float l = lse[(int64_t)bn * s + r.row1];
      r.lse1 = l > 0.5f * kNegInf ? l * kLog2e : INFINITY;
      r.dl1 = delta[(int64_t)bn * s + r.row1];
    }
    const uint32_t q_rows = sQ + cwg * 64 * 128, do_rows = sDo + cwg * 64 * 128;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    if (n_vis > 0) {
      float sc[32], dp[32];
      uint32_t da[4][4];
      hopper::mbar_wait(full(0), 0);
      hopper::wgmma_fence();
      issue_abt<D>(sc, q_rows, C::kSlabQ, sK, C::kSlabKV);
      issue_abt<D>(dp, do_rows, C::kSlabQ, sV, C::kSlabKV);
      hopper::wgmma_commit();
      // tile it: its dS.K goes to the tensor cores, then tile it + 1's S and
      // dP behind it; the last tile is peeled off so that every issue in the
      // loop is unconditional
      for (int it = 0; it < n_vis - 1; ++it) {
        const int st = it % S, nst = (it + 1) % S;
        hopper::wgmma_wait<0>();  // S and dP of tile it
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        ds_frags(da, sc, dp, r, it >= n_full, it * kDqBlockN + 2 * t, sk, causal, offset, c,
                 sm_scale);
        hopper::wgmma_fence();
        issue_ab<D>(dq, da, sK + st * C::kKVBytes, C::kSlabKV);
        hopper::wgmma_commit();
        hopper::mbar_wait(full(nst), ((it + 1) / S) & 1);
        issue_abt<D>(sc, q_rows, C::kSlabQ, sK + nst * C::kKVBytes, C::kSlabKV);
        issue_abt<D>(dp, do_rows, C::kSlabQ, sV + nst * C::kKVBytes, C::kSlabKV);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // dS.K of tile it (groups complete in order)
        hopper::fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
        if (lane == 0) hopper::mbar_arrive(empty(st));
      }
      const int last = n_vis - 1;
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      ds_frags(da, sc, dp, r, last >= n_full, last * kDqBlockN + 2 * t, sk, causal, offset, c,
               sm_scale);
      hopper::wgmma_fence();
      issue_ab<D>(dq, da, sK + (last % S) * C::kKVBytes, C::kSlabKV);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(da[kk]);
    }
    store_rows<D>(dq, smem, base, q_rows, C::kSlabQ, &tdq, q_start + cwg * 64, bn, s, cwg, tid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     int bkv_total, int s, int sk, int group, float sm_scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int S = kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + C::kOffV, sQ = base + C::kOffQ, sDo = base + C::kOffDo;
  float* rows_lse = reinterpret_cast<float*>(smem + C::kOffRows);  // + st * 128: lse, + 64: delta
  const uint32_t kv_full = base + C::kOffBar;
  auto full = [&](int st) { return kv_full + 8u * (1 + st); };
  auto empty = [&](int st) { return kv_full + 8u * (1 + S + st); };

  const int bkv = blockIdx.x % bkv_total;
  const int kb = static_cast<int>(blockIdx.x / bkv_total);  // causal: lowest keys see most rows
  const int k_start = kb * kDkvBlockN;
  const int offset = sk - s;
  // per query head, Q tiles [qt0, q_tiles): from the first holding a row
  // that sees key k_start
  const int q_begin = causal ? max(0, k_start - offset) : 0;
  const int qt0 = q_begin / kDkvBlockM;
  const int q_tiles = (s + kDkvBlockM - 1) / kDkvBlockM;
  const int per_head = max(0, q_tiles - qt0);
  const int n_iter = group * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int st = 0; st < S; ++st) {
      hopper::mbar_init(full(st), 32);  // the producer warp: TMA bytes + lse/delta stores
      hopper::mbar_init(empty(st), kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hopper::tma_prefetch_desc(&tk);
        hopper::tma_prefetch_desc(&tv);
        hopper::tma_prefetch_desc(&tq);
        hopper::tma_prefetch_desc(&tdo);
        // K and V: the boxes of 64 keys that start inside sk (a box wholly
        // past sk only feeds its own keys' dk/dv, which are not stored)
        const int boxes = min(kDkvBlockN / kBox, (sk - k_start + kBox - 1) / kBox);
        hopper::mbar_arrive_expect_tx(kv_full, 2 * boxes * C::kSlabs * kBoxBytes);
        for (int j = 0; j < C::kSlabs; ++j) {
          for (int h = 0; h < boxes; ++h) {
            const uint32_t off = j * C::kSlabKV + h * kBoxBytes;
            hopper::tma_load_3d(sK + off, &tk, kv_full, 64 * j, k_start + h * kBox, bkv);
            hopper::tma_load_3d(sV + off, &tv, kv_full, 64 * j, k_start + h * kBox, bkv);
          }
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % S;
        const int bn = bkv * group + it / per_head;
        const int q0 = (qt0 + it % per_head) * kDkvBlockM;
        if (it >= S) hopper::mbar_wait(empty(st), ((it / S) - 1) & 1);
        // each lane's rows of lse (log2 units; +inf where p must be 0) and
        // delta, stored before its arrival (release) on the full barrier
        float* rows = rows_lse + st * 2 * kDkvBlockM;
        for (int r = lane; r < kDkvBlockM; r += 32) {
          const int row = q0 + r;
          const float l = row < s ? lse[(int64_t)bn * s + row] : kNegInf;
          rows[r] = l > 0.5f * kNegInf ? l * kLog2e : INFINITY;
          rows[kDkvBlockM + r] = row < s ? delta[(int64_t)bn * s + row] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(full(st), 2 * C::kQBytes);
          for (int j = 0; j < C::kSlabs; ++j) {
            const uint32_t off = st * C::kQBytes + j * C::kSlabQ;
            hopper::tma_load_3d(sQ + off, &tq, full(st), 64 * j, q0, bn);
            hopper::tma_load_3d(sDo + off, &tdo, full(st), 64 * j, q0, bn);
          }
        } else {
          hopper::mbar_arrive(full(st));
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int cwg = threadIdx.x / 128 - 1;  // 0 or 1: keys 64 * cwg ..
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int key_lo = k_start + cwg * 64;  // this consumer's first key
    const int key0 = key_lo + (tid / 32) * 16 + g, key1 = key0 + 8;
    const float c = sm_scale * kLog2e;
    const uint32_t k_rows = sK + cwg * 64 * 128, v_rows = sV + cwg * 64 * 128;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % S;
      const int q0 = (qt0 + it % per_head) * kDkvBlockM;
      const uint32_t q_tile = sQ + st * C::kQBytes, do_tile = sDo + st * C::kQBytes;
      const float* rows = rows_lse + st * 2 * kDkvBlockM;
      float sc[32], dp[32];
      hopper::mbar_wait(full(st), (it / S) & 1);
      hopper::wgmma_fence();
      issue_abt<D>(sc, k_rows, C::kSlabKV, q_tile, C::kSlabQ);
      hopper::wgmma_commit();
      issue_abt<D>(dp, v_rows, C::kSlabKV, do_tile, C::kSlabQ);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S^T; dP^T still on the tensor cores
      hopper::fence_regs(sc);
      // accumulator layout: sc[4j + e] is (key0, query row q0 + 8j + 2t + e),
      // sc[4j + 2 + e] is (key1, the same row).  Only a tile that crosses
      // this consumer's causal diagonal, or a block that runs past sk, masks.
      const bool mask = key_lo + 64 > sk || (causal && key_lo + 63 > q0 + offset);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j + 2 * t + e;
          const float l2 = rows[cl];
          float p0 = hopper::ex2(fmaf(sc[4 * j + e], c, -l2));
          float p1 = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -l2));
          if (mask) {
            const int row = q0 + cl;
            if (!(key0 < sk && (!causal || key0 <= row + offset))) p0 = 0.f;
            if (!(key1 < sk && (!causal || key1 <= row + offset))) p1 = 0.f;
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = rows[kDkvBlockM + 8 * j + 2 * t + e];
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl) * sm_scale;
          dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl) * sm_scale;
        }
      }
      uint32_t pa[4][4], sa[4][4];
      hopper::acc_to_a_frags<64>(pa, sc);  // p^T rounded to bf16
      hopper::acc_to_a_frags<64>(sa, dp);  // ds^T rounded to bf16
      hopper::wgmma_fence();
      issue_ab<D>(dv, pa, do_tile, C::kSlabQ);
      issue_ab<D>(dk, sa, q_tile, C::kSlabQ);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::fence_regs(pa[kk]);
        hopper::fence_regs(sa[kk]);
      }
      if (lane == 0) hopper::mbar_arrive(empty(st));
    }
    store_rows<D>(dk, smem, base, k_rows, C::kSlabKV, &tdk, key_lo, bkv, sk, cwg, tid);
    store_rows<D>(dv, smem, base, v_rows, C::kSlabKV, &tdv, key_lo, bkv, sk, cwg, tid);
  }
}

// above 48 KB a block's dynamic shared memory has to be asked for, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int bn,
                   int s, int bkv, int sk, float sm_scale, int causal, int which,
                   cudaStream_t stream) {
  // q, k, v and dO are encoded once and shared by both kernels
  CUtensorMap tq, tk, tv, tdo, t0, t1;
  cudaError_t err;
  if ((err = hopper::make_tmap_bf16_3d(&tq, q, D, s, bn, kBox)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&tk, k, D, sk, bkv, kBox)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&tv, v, D, sk, bkv, kBox)) != cudaSuccess) return err;
  if ((err = hopper::make_tmap_bf16_3d(&tdo, dout, D, s, bn, kBox)) != cudaSuccess) return err;
  if (which & 1) {
    static bool smem_set = false;
    if ((err = allow_smem(flash_bwd_dq_kernel<D>, DqCfg<D>::kSmemBytes, smem_set)) != cudaSuccess)
      return err;
    if ((err = hopper::make_tmap_bf16_3d(&t0, dq, D, s, bn, kBox)) != cudaSuccess) return err;
    const int q_blocks = (s + kDqBlockM - 1) / kDqBlockM;
    const long long blocks = static_cast<long long>(q_blocks) * bn;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    flash_bwd_dq_kernel<D><<<static_cast<unsigned>(blocks), kThreads, DqCfg<D>::kSmemBytes,
                             stream>>>(tq, tk, tv, tdo, t0, lse, delta, bn, s, sk, bn / bkv,
                                       sm_scale, causal, q_blocks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (which & 2) {
    static bool smem_set = false;
    if ((err = allow_smem(flash_bwd_dkv_kernel<D>, DkvCfg<D>::kSmemBytes, smem_set)) !=
        cudaSuccess)
      return err;
    if ((err = hopper::make_tmap_bf16_3d(&t0, dk, D, sk, bkv, kBox)) != cudaSuccess) return err;
    if ((err = hopper::make_tmap_bf16_3d(&t1, dv, D, sk, bkv, kBox)) != cudaSuccess) return err;
    const int k_blocks = (sk + kDkvBlockN - 1) / kDkvBlockN;
    const long long blocks = static_cast<long long>(k_blocks) * bkv;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    flash_bwd_dkv_kernel<D><<<static_cast<unsigned>(blocks), kThreads, DkvCfg<D>::kSmemBytes,
                              stream>>>(tq, tk, tv, tdo, t0, t1, lse, delta, bkv, s, sk, bn / bkv,
                                        sm_scale, causal);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// q, dout [bn, s, d], k/v [bkv, sk, d] bf16 contiguous, 16-byte aligned
// (TMA); lse, delta [bn, s] fp32.  `which`: 1 launches the dq kernel into dq
// [bn, s, d], 2 the dk/dv kernel into dk, dv [bkv, sk, d] (each summed over
// the bn / bkv query heads that share a K/V row), 3 both, dq first; an
// output not asked for may be null.  Returns the first cudaError_t (0 on
// success).
extern "C" int dlbb_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, void* dk,
                                   void* dv, int bn, int s, int bkv, int sk, int d,
                                   float sm_scale, int causal, int which, void* stream) {
  if (bn <= 0 || s <= 0 || bkv <= 0 || sk <= 0 || bn % bkv != 0 || which < 1 || which > 3)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      ((which & 1) && !aligned16(dq)) || ((which & 2) && (!aligned16(dk) || !aligned16(dv))))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 64:
      return (int)launch<64>(q, k, v, dout, l, dl, dq, dk, dv, bn, s, bkv, sk, sm_scale, causal,
                             which, st);
    case 128:
      return (int)launch<128>(q, k, v, dout, l, dl, dq, dk, dv, bn, s, bkv, sk, sm_scale, causal,
                              which, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
