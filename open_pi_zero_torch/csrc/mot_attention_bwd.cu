// Backward of the softcapped, masked GQA/MQA attention for Hopper (sm_90a):
// given q, k, v, the additive fp32 mask, the softcap and the cotangent g of
//
//   out = softmax(tanh(q k^T * scale / softcap) * softcap + mask) v,
//
// dq, dk and dv. Replaces the backward of the JAX package's custom VJP,
// open_pi_zero_tpu/ops/pallas_attention.py::_vjp_bwd, which runs jax.vjp
// through ops/attention.py::mot_attention_xla (XLA einsums at
// Precision.HIGHEST for fp32). The forward is csrc/mot_attention.cu (K1),
// which saves nothing for this: like the JAX VJP, the backward recomputes
// its statistics from q, k, v and the mask.
//
// Arithmetic (ops/fused_attention.py::mot_attention_bwd_ref repeats it in
// plain PyTorch), per folded row i and key j, all in fp32:
//   x = q_i . k_j * scale, t = tanh(x / softcap), s = t * softcap + mask
//   (no softcap: s = x + mask, and 1 - t^2 below is 1)
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)    (the exact row softmax)
//   dP = g_i . v_j, rounded to bf16 once in bf16 (the transpose of the
//   forward's cast of p)
//   delta_i = sum_j p dP, dS = (p (1 - t^2)) (dP - delta_i) scale
//   dq_i = sum_j dS k_j, dk_j = sum_i dS q_i, dv_j = sum_i p~ g_i,
// where p~ is p rounded to V's dtype, as the forward rounds it before p v.
// The mask takes no gradient. dk and dv sum over all G * Lq folded rows of
// their kv head. dq, dk and dv are rounded to the inputs' dtype. A fully
// masked row (every mask entry MASK_NEG = finfo(float32).min) has s =
// MASK_NEG at every key, so p is uniform and its dS still flows through
// (1 - t^2), as in plain autograd; keys past Lkv are excluded by bounds.
//
// Layout: q, g, dq [B, Lq, Hq, D]; k, v, dk, dv [B, Lkv, Hkv, D]; all
// contiguous; mask [B, 1, Lq, Lkv] fp32 with a unit last stride, its batch
// and row strides passed in. The GQA group is folded into the rows as in
// K1: row i of kv head h is query position i / G of query head h G + i % G.
//
// Two kernels, launched in order on one stream; the wrapper allocates a
// scratch of p~ (V's dtype) and dS (fp32), each [B, Hkv, G Lq, ld] with
// ld = round_up(Lkv, 32), that lives only inside one backward call.
//
// 1. mot_attention_bwd_rows_kernel: one block per (batch, kv head, 32
//    folded rows), 16 warps. It keeps its rows' q and g and two fp32 rows
//    of Lkv in shared memory, and streams K, then V, then K again through
//    a two-stage ring of 32-row tiles (16-byte cp.async, the copy of tile
//    n + 1 overlapping the products on tile n):
//      - K: x = q k^T; buffer X takes 1 - t^2, buffer Y takes s;
//      - the row softmax in Y (p, fp32), p~ to the scratch;
//      - V: dP = g v^T; delta's partial sums; Y takes p (1 - t^2), X dP;
//      - dS = Y (X - delta) scale into X and the scratch;
//      - K: dq = dS k, stored in q's dtype.
//    A 32 x 32 score tile is 2 x 4 warp tiles of 16 x 8; each is computed
//    by two warps over the two halves of D, so that 16 warps share the SM
//    (one block fills the shared memory: about 214 KB in fp32 at D = 256,
//    Lkv = 281); each warp keeps its A fragments (q, then g) in registers
//    for the whole phase and loads only the tile's B fragments, and the two
//    warps of a tile swap the partial sums of one row each through shared
//    memory, so that both share the epilogue (tanh, mask, the softmax's and
//    dS's inputs).
// 2. mot_attention_bwd_keys_kernel: one block per (batch, kv head, 32 keys,
//    64 columns of D (all of D where it is smaller), dk or dv), 4 warps.
//    dv = p~^T g and dk = dS^T q over all G Lq rows: a two-stage ring of
//    64-row stages of the scratch's 32 columns and the matching rows of g
//    or q; each warp takes 16 rows of each stage into a whole 32 x D-tile
//    of accumulators (every operand fragment feeds 2 or 8 products), and
//    the 4 warps' sums are added in warp order through shared memory. The
//    split is over the outputs, not the reduction: no block adds into
//    another's output, no atomics, so two calls are bitwise equal. At
//    B = 16, Hkv = 1, Lkv = 281 the 9 key tiles of a batch row times 4 D
//    tiles times dk, dv give 1152 blocks.
//
// Why p~ and dS are stored rather than recomputed on the key side: at the
// training shape each is 40 MB; writing and reading both moves about 160
// MB (0.05 ms at 3.35 TB/s), where recomputing q k^T and g v^T per key tile
// would cost 4N more products (N = B Hq Lq Lkv D). The forward still saves
// nothing: the scratch lives inside one call.
//
// Products. fp32: 3xTF32 on the tensor cores (mma.sync m16n8k8: a_big b_big
// + a_big b_small + a_small b_big, each operand cut into its top 10
// mantissa bits and the next 10), as in K1, since Precision.HIGHEST rules
// out plain TF32. bf16: the same TF32 instruction, with the operands read
// from bf16 tiles and widened; a bf16 value is exact in TF32, so a product
// of two bf16 operands (q k^T, g v^T, p~^T g) is one exact TF32 product,
// and a product with the fp32 dS (dS k, dS^T q) takes two, dS cut into two
// TF32 parts. One code path serves both dtypes; the bf16 backward runs on
// no path of the port (training is fp32), where a bf16 mma would only
// halve the product time.
//
// What bounds it. At the fp32 training shape the VJP needs 8N = 20.7 GFLOP
// (0.125 ms at a third of the 495 TFLOP/s TF32 peak) and moves about 0.1
// GB; these kernels do 10N (q k^T is recomputed) and write and read the
// scratch besides. On an H100 (chip_smoke.py phase 2) the row side takes
// about 0.58 ms and the key side 0.33 ms per training-shape launch, 6x and
// 5x their operation bounds, so neither bytes nor operations bound them:
// the row side's one 16-warp block per SM waits at every 32-key tile for
// the next tile's copy and for the barrier of the D halves' exchange
// (holding the A fragments in registers, 2 words per 3 products instead of
// K1's 6, took it from 0.67 to 0.58 ms; a three-stage ring, which needs q
// and g read from device memory into registers, spilled at the 128
// registers that 16 warps leave each thread and was slower). The key
// side's blocks read p~ and dS once per D tile and q and g once per key
// tile, about 1 GB through the L2 per call, with three blocks per SM (148
// registers a thread; the shared memory would take four).
//
// Limits: D in {16, 32, 64, 128, 256}; a row block holds two fp32 rows of
// round_up(Lkv, 32) + 4 floats per folded row beside q, g and the ring,
// which bounds Lkv (bwd_max_lkv in the wrapper: 352 at D = 256).
// The helpers below (cp.async, mma, the TF32 split) are a copy of K1's, so
// that this source builds, and is hashed for its build, on its own.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKeys = 32;      // K/V rows per ring tile; keys per key-side block
constexpr int kRows = 32;      // folded rows per row-side block
constexpr int kWarpsM = kRows / 16;
constexpr int kWarpsN = kKeys / 8;
constexpr int kRowThreads = 32 * kWarpsM * kWarpsN * 2;  // x2: the two halves of D
constexpr int kDqWarpsN = 2 * kWarpsN;                   // warps over D in the dq phase
constexpr int kStageRows = 64;  // folded rows per key-side stage
constexpr int kKeyWarps = kStageRows / 16;
constexpr int kKeyThreads = 32 * kKeyWarps;
constexpr int kKeyStages = 2;
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use on Hopper

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plans, in bytes; mirrored by ops/fused_attention.py::bwd_smem_bytes.
struct RowPlan {
  int q_stride, k_stride, s_stride, x_stride;
  int q_off, g_off, ring_off, xs_off, ys_off, xch_off, delta_off, total;
};

__host__ __device__ inline RowPlan make_row_plan(int esize, int d, int lkv) {
  RowPlan p;
  p.q_stride = d + 16 / esize;  // q, g, and the K/V tiles of the score phases
  p.k_stride = d + 8;           // K tiles of the dq phase (conflict-free B fragments)
  p.s_stride = round_up(lkv, kKeys) + 4;
  p.x_stride = kKeys + 4;       // the D halves' exchange tile
  p.q_off = 0;
  p.g_off = kRows * p.q_stride * esize;
  p.ring_off = 2 * p.g_off;
  p.xs_off = p.ring_off + 2 * kKeys * p.k_stride * esize;
  p.ys_off = p.xs_off + kRows * p.s_stride * 4;
  p.xch_off = p.ys_off + kRows * p.s_stride * 4;
  p.delta_off = p.xch_off + kRows * p.x_stride * 4;
  p.total = p.delta_off + kWarpsN * kRows * 4;
  return p;
}

struct KeyPlan {
  int a_stride, b_stride, red_stride, b_off, stage_bytes, total;
};

__host__ __device__ inline KeyPlan make_key_plan(int esize, int dt) {
  KeyPlan p;
  p.a_stride = kKeys + 8;  // elements; an fp32 stage row is 160 B
  p.b_stride = dt + 8;
  p.red_stride = dt + 4;
  p.b_off = kStageRows * p.a_stride * 4;  // sized for fp32 dS
  p.stage_bytes = p.b_off + kStageRows * p.b_stride * esize;
  const int ring = kKeyStages * p.stage_bytes;
  const int red = kKeyWarps * kKeys * p.red_stride * 4;  // overlays the ring at the end
  p.total = ring > red ? ring : red;
  return p;
}

// ---- PTX helpers (a copy of csrc/mot_attention.cu's) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, each a TF32 value (the top 10 mantissa bits, cut by a mask).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// An operand fragment of N fp32 values, cut into two TF32 parts when kSplit;
// otherwise the value is taken as it is (a widened bf16 value is exact).
template <int N, bool kSplit>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (kSplit) {
        split_tf32(x[i], big[i], small[i]);
      } else {
        big[i] = __float_as_uint(x[i]);
      }
    }
  }
};

// big += a_big b_big; small += a_small b_big + a_big b_small for the
// operands that are cut; big and small may be one accumulator.
template <bool kSA, bool kSB>
__device__ __forceinline__ void mma_x(float (&big)[4], float (&small)[4], const Frag<4, kSA>& a,
                                      const Frag<2, kSB>& b) {
  if constexpr (kSA) mma_tf32(small, a.small, b.big);
  if constexpr (kSB) mma_tf32(small, a.big, b.small);
  mma_tf32(big, a.big, b.big);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void store4(float* dst, float4 x) {
    *reinterpret_cast<float4*>(dst) = x;
  }
  static __device__ __forceinline__ void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads, 1)
mot_attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const float* __restrict__ mask,
                              const T* __restrict__ gout, T* __restrict__ dq,
                              T* __restrict__ p_out, float* __restrict__ ds_out, int lq, int lkv,
                              int hq, int hkv, long long mask_sb, long long mask_sq, float scale,
                              float softcap) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kChunk = 16 / sizeof(T), kCopies = D / kChunk;
  constexpr int kStep = kRowThreads / kCopies;
  constexpr int kHalfSteps = D / 16;  // k steps of 8 in half of D
  constexpr int kOutTiles = (D / 8 + kDqWarpsN - 1) / kDqWarpsN;
  constexpr int kTpr = kRowThreads / kRows;  // threads per row in the row passes

  extern __shared__ __align__(128) unsigned char smem[];
  const RowPlan plan = make_row_plan(sizeof(T), D, lkv);
  T* qs = reinterpret_cast<T*>(smem + plan.q_off);
  T* gs = reinterpret_cast<T*>(smem + plan.g_off);
  T* ring = reinterpret_cast<T*>(smem + plan.ring_off);
  float* xs = reinterpret_cast<float*>(smem + plan.xs_off);  // [kRows][s_stride]
  float* ys = reinterpret_cast<float*>(smem + plan.ys_off);
  float* xch = reinterpret_cast<float*>(smem + plan.xch_off);  // [kRows][x_stride]
  float* dsum = reinterpret_cast<float*>(smem + plan.delta_off);  // [kWarpsN][kRows]

  const int group = hq / hkv;
  const int rows_total = group * lq;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, rows_total - row0);
  const int h_kv = blockIdx.y;
  const long long b = blockIdx.z;
  const int n_tiles = (lkv + kKeys - 1) / kKeys;
  const int ld = n_tiles * kKeys;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kh = warp / (kWarpsM * kWarpsN);  // score phases: which half of D
  const int wm = (warp / kWarpsN) % kWarpsM, wn = warp % kWarpsN;
  const int g = lane / 4, t4 = lane % 4;
  // score phases: the one row of the warp's 16 x 8 tile whose two elements
  // this thread finishes (the two halves of D take one row each)
  const int my_r = wm * 16 + g + 8 * kh;
  const float* mask_b = mask + b * mask_sb;
  const long long scratch_row0 = (b * hkv + h_kv) * rows_total + row0;

  // ---- q and g rows, then K, V and K again through the ring ----
  const int c_own = tid % kCopies;
  for (int r = tid / kCopies; r < kRows; r += kStep) {
    long long off = 0;
    int bytes = 0;
    if (r < n_rows) {
      const int i = row0 + r, qi = i / group, h = h_kv * group + i % group;
      off = ((b * lq + qi) * hq + h) * D + c_own * kChunk;
      bytes = 16;
    }
    cp_async16(qs + r * plan.q_stride + c_own * kChunk, q + off, bytes);
    cp_async16(gs + r * plan.q_stride + c_own * kChunk, gout + off, bytes);
  }
  const long long kv_row = static_cast<long long>(hkv) * D;  // elements between keys
  const int total = 3 * n_tiles;
  auto load_tile = [&](int i) {  // phase 0: K for the scores, 1: V for dP, 2: K for dq
    const int phase = i / n_tiles;
    const int stride = phase == 2 ? plan.k_stride : plan.q_stride;
    const int j0 = (i - phase * n_tiles) * kKeys;
    const T* src = (phase == 1 ? v : k) + (b * lkv * hkv + h_kv) * D + c_own * kChunk;
    T* dst = ring + (i & 1) * kKeys * plan.k_stride + c_own * kChunk;
    for (int jj = tid / kCopies; jj < kKeys; jj += kStep) {
      const bool ok = j0 + jj < lkv;  // rows past Lkv are zero-filled
      cp_async16(dst + jj * stride, ok ? src + (j0 + jj) * kv_row : k, ok ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  // The warp's A fragments of the score phases (q, then g) over its 16
  // rows and its half of D, widened to fp32, held in registers for the
  // whole phase: a k step then loads only its 2 B words from the ring tile.
  float afr[kHalfSteps][4];
  auto load_frags = [&](const T* rows) {
    const T* ar = rows + (wm * 16 + g) * plan.q_stride + kh * kHalfSteps * 8 + t4;
#pragma unroll
    for (int ks = 0; ks < kHalfSteps; ++ks) {
      afr[ks][0] = widen(ar[ks * 8]);
      afr[ks][1] = widen(ar[8 * plan.q_stride + ks * 8]);
      afr[ks][2] = widen(ar[ks * 8 + 4]);
      afr[ks][3] = widen(ar[8 * plan.q_stride + ks * 8 + 4]);
    }
  };
  // One ring tile's 32 x 32 products of the score phases: each warp's
  // 16 x 8 tile over its half of D (independent accumulators per k-step
  // parity and for the small terms, so that the mma chains overlap); then
  // each of the two warps of a tile hands the other the partial of the row
  // it does not finish, through xch. out: this thread's two elements of
  // row my_r, summed over both halves of D.
  auto tile_products = [&](float (&out)[2], const T* tile) {
    float c[4][4] = {};
    const T* br = tile + (wn * 8 + g) * plan.q_stride + kh * kHalfSteps * 8 + t4;
#pragma unroll
    for (int ks = 0; ks < kHalfSteps; ++ks) {
      const float bf[2] = {widen(br[ks * 8]), widen(br[ks * 8 + 4])};
      Frag<4, kF32> fa;
      Frag<2, kF32> fb;
      fa.set(afr[ks]);
      fb.set(bf);
      mma_x(c[ks & 1], c[2 + (ks & 1)], fa, fb);
    }
    float sum[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) sum[x] = (c[2][x] + c[3][x]) + (c[0][x] + c[1][x]);
    const float give0 = kh ? sum[0] : sum[2], give1 = kh ? sum[1] : sum[3];
    *reinterpret_cast<float2*>(xch + (wm * 16 + g + 8 * (1 - kh)) * plan.x_stride + wn * 8 + 2 * t4) =
        make_float2(give0, give1);
    __syncthreads();  // the partials are written and the tile is consumed
    const float2 o = *reinterpret_cast<const float2*>(xch + my_r * plan.x_stride + wn * 8 + 2 * t4);
    out[0] = (kh ? sum[2] : sum[0]) + o.x;
    out[1] = (kh ? sum[3] : sum[1]) + o.y;
  };

  // ---- K: scores; X = 1 - t^2, Y = s ----
  const float* mask_row = mask_b + static_cast<long long>((row0 + my_r) / group) * mask_sq;
  for (int i = 0; i < n_tiles; ++i) {
    load_tile(i + 1);  // the next K tile, or V tile 0 during the softmax
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == 0) load_frags(qs);
    const T* tile = ring + (i & 1) * kKeys * plan.k_stride;
    const int j = i * kKeys + wn * 8 + 2 * t4;
    float mk[2];  // read before the products hide their latency
#pragma unroll
    for (int e = 0; e < 2; ++e) mk[e] = my_r < n_rows && j + e < lkv ? mask_row[j + e] : 0.f;
    float c[2];
    tile_products(c, tile);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (j + e >= lkv) continue;
      float s = 0.f, dt = 1.f;
      if (my_r < n_rows) {
        s = c[e] * scale;
        if (softcap > 0.f) {
          const float t = tanhf(s / softcap);
          s = t * softcap;
          dt = 1.f - t * t;
        }
        s += mk[e];
      }
      xs[my_r * plan.s_stride + j + e] = dt;
      ys[my_r * plan.s_stride + j + e] = s;
    }
  }
  __syncthreads();

  // ---- the row softmax in Y; p~ to the scratch ----
  // kTpr threads take one row, each every kTpr-th 4-key chunk of it.
  const int sr = tid / kTpr, part = tid % kTpr;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  {
    float* yrow = ys + sr * plan.s_stride;
    float m = neg_inf;
    for (int j = 4 * part; j < lkv; j += 4 * kTpr) {
      const float4 x = *reinterpret_cast<const float4*>(yrow + j);
      m = fmaxf(m, x.x);
      if (j + 1 < lkv) m = fmaxf(m, x.y);
      if (j + 2 < lkv) m = fmaxf(m, x.z);
      if (j + 3 < lkv) m = fmaxf(m, x.w);
    }
#pragma unroll
    for (int o = kTpr / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = 4 * part; j < lkv; j += 4 * kTpr) {
      float4 x = *reinterpret_cast<const float4*>(yrow + j);
      x.x = expf(x.x - m);
      x.y = j + 1 < lkv ? expf(x.y - m) : 0.f;
      x.z = j + 2 < lkv ? expf(x.z - m) : 0.f;
      x.w = j + 3 < lkv ? expf(x.w - m) : 0.f;
      *reinterpret_cast<float4*>(yrow + j) = x;
      sum += x.x + x.y + x.z + x.w;
    }
#pragma unroll
    for (int o = kTpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    T* prow = p_out + (scratch_row0 + sr) * ld;
    for (int j = 4 * part; j < ld; j += 4 * kTpr) {
      float4 x = *reinterpret_cast<const float4*>(yrow + j);
      x.x = j < lkv ? x.x / sum : 0.f;
      x.y = j + 1 < lkv ? x.y / sum : 0.f;
      x.z = j + 2 < lkv ? x.z / sum : 0.f;
      x.w = j + 3 < lkv ? x.w / sum : 0.f;
      *reinterpret_cast<float4*>(yrow + j) = x;
      if (sr < n_rows) Out<T>::store4(prow + j, x);
    }
  }
  __syncthreads();

  // ---- V: dP = g v^T; delta's partials; Y = p (1 - t^2), X = dP ----
  float d_part = 0.f;  // this thread's share of row my_r's delta
  for (int i = n_tiles; i < 2 * n_tiles; ++i) {
    load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (i == n_tiles) load_frags(gs);
    const T* tile = ring + (i & 1) * kKeys * plan.k_stride;
    const int j = (i - n_tiles) * kKeys + wn * 8 + 2 * t4;
    float c[2];
    tile_products(c, tile);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (j + e >= lkv) continue;
      const float dp = round_to<T>(c[e]);
      float* x = xs + my_r * plan.s_stride + j + e;
      float* y = ys + my_r * plan.s_stride + j + e;
      d_part += *y * dp;
      *y = *y * *x;
      *x = dp;
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) d_part += __shfl_xor_sync(0xffffffffu, d_part, o);
  if (t4 == 0) dsum[wn * kRows + my_r] = d_part;
  __syncthreads();

  // ---- dS = Y (X - delta) scale, into X and the scratch ----
  {
    float delta = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsN; ++w) delta += dsum[w * kRows + sr];
    float* xrow = xs + sr * plan.s_stride;
    const float* yrow = ys + sr * plan.s_stride;
    float* drow = ds_out + (scratch_row0 + sr) * ld;
    for (int j = 4 * part; j < ld; j += 4 * kTpr) {
      const float4 x = *reinterpret_cast<const float4*>(xrow + j);
      const float4 y = *reinterpret_cast<const float4*>(yrow + j);
      float4 d;
      d.x = j < lkv ? y.x * (x.x - delta) * scale : 0.f;
      d.y = j + 1 < lkv ? y.y * (x.y - delta) * scale : 0.f;
      d.z = j + 2 < lkv ? y.z * (x.z - delta) * scale : 0.f;
      d.w = j + 3 < lkv ? y.w * (x.w - delta) * scale : 0.f;
      *reinterpret_cast<float4*>(xrow + j) = d;
      if (sr < n_rows) *reinterpret_cast<float4*>(drow + j) = d;
    }
  }
  __syncthreads();

  // ---- K again: dq = dS k, fp32 accumulation; 16 warps as 2 x 8 over D ----
  const int wd = warp % kDqWarpsN, wq = warp / kDqWarpsN;
  float acc[kOutTiles][4] = {};
  for (int i = 2 * n_tiles; i < total; ++i) {
    if (i + 1 < total) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = ring + (i & 1) * kKeys * plan.k_stride;
    const int j0 = (i - 2 * n_tiles) * kKeys;
#pragma unroll
    for (int ks = 0; ks < kKeys / 8; ++ks) {
      const float* pr = xs + (wq * 16 + g) * plan.s_stride + j0 + ks * 8 + t4;
      const float af[4] = {pr[0], pr[8 * plan.s_stride], pr[4], pr[8 * plan.s_stride + 4]};
      Frag<4, true> fa;
      fa.set(af);
#pragma unroll
      for (int ot = 0; ot < kOutTiles; ++ot) {
        const int n8 = wd + ot * kDqWarpsN;
        if (n8 >= D / 8) continue;
        const T* kr = tile + (ks * 8 + t4) * plan.k_stride + n8 * 8 + g;
        const float bf[2] = {widen(kr[0]), widen(kr[4 * plan.k_stride])};
        Frag<2, kF32> fb;
        fb.set(bf);
        mma_x(acc[ot], acc[ot], fa, fb);
      }
    }
    __syncthreads();  // the stage is consumed before the load into it
  }
  cp_async_wait<0>();
#pragma unroll
  for (int ot = 0; ot < kOutTiles; ++ot) {
    const int n8 = wd + ot * kDqWarpsN;
    if (n8 >= D / 8) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wq * 16 + g + 8 * half;
      if (r >= n_rows) continue;
      const int i = row0 + r, qi = i / group, h = h_kv * group + i % group;
      Out<T>::store2(dq + ((b * lq + qi) * hq + h) * D + n8 * 8 + 2 * t4, acc[ot][2 * half],
                     acc[ot][2 * half + 1]);
    }
  }
}

// dv (A = p~ in T) or dk (A = dS in fp32) of one block: 32 keys x DT
// columns of D from d0, summed over all rows of the (batch, kv head).
template <typename T, typename TA, int DT, bool kSA, bool kSB>
__device__ __forceinline__ void key_block(const TA* __restrict__ a_src, const T* __restrict__ b_src,
                                          T* __restrict__ out, int lq, int lkv, int hq, int hkv,
                                          int head_dim, int kt, int d0) {
  constexpr int kAChunk = 16 / sizeof(TA), kACopies = kKeys / kAChunk;
  constexpr int kBChunk = 16 / sizeof(T), kBCopies = DT / kBChunk;
  constexpr int kNT = DT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const KeyPlan plan = make_key_plan(sizeof(T), DT);
  const int group = hq / hkv;
  const int rows_total = group * lq;
  const int ld = round_up(lkv, kKeys);
  const int n_stages = (rows_total + kStageRows - 1) / kStageRows;
  const int h_kv = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const TA* a_base = a_src + (b * hkv + h_kv) * rows_total * ld + kt * kKeys;

  auto load_stage = [&](int s) {
    unsigned char* st = smem + (s % kKeyStages) * plan.stage_bytes;
    TA* at = reinterpret_cast<TA*>(st);
    T* bt = reinterpret_cast<T*>(st + plan.b_off);
    const int i0 = s * kStageRows;
    for (int e = tid; e < kStageRows * kACopies; e += kKeyThreads) {
      const int r = e / kACopies, c = e % kACopies, i = i0 + r;
      const bool ok = i < rows_total;  // rows past the end are zero-filled
      cp_async16(at + r * plan.a_stride + c * kAChunk, ok ? a_base + static_cast<long long>(i) * ld + c * kAChunk : a_base,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kStageRows * kBCopies; e += kKeyThreads) {
      const int r = e / kBCopies, c = e % kBCopies, i = i0 + r;
      long long off = 0;
      int bytes = 0;
      if (i < rows_total) {
        const int qi = i / group, h = h_kv * group + i % group;
        off = ((b * lq + qi) * hq + h) * head_dim + d0 + c * kBChunk;
        bytes = 16;
      }
      cp_async16(bt + r * plan.b_stride + c * kBChunk, b_src + off, bytes);
    }
  };

  float acc[2][kNT][4] = {};
  load_stage(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) load_stage(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = smem + (s % kKeyStages) * plan.stage_bytes;
    const TA* at = reinterpret_cast<const TA*>(st);
    const T* bt = reinterpret_cast<const T*>(st + plan.b_off);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kr = warp * 16 + kk * 8;  // this warp's rows of the stage
      Frag<4, kSA> fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const TA* ap = at + (kr + t4) * plan.a_stride + mt * 16 + g;
        const float af[4] = {widen(ap[0]), widen(ap[8]), widen(ap[4 * plan.a_stride]),
                             widen(ap[4 * plan.a_stride + 8])};
        fa[mt].set(af);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const T* bp = bt + (kr + t4) * plan.b_stride + nt * 8 + g;
        const float bf[2] = {widen(bp[0]), widen(bp[4 * plan.b_stride])};
        Frag<2, kSB> fb;
        fb.set(bf);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_x(acc[mt][nt], acc[mt][nt], fa[mt], fb);
      }
    }
    __syncthreads();  // the stage is consumed before the load into it
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- the warps' sums added in warp order, stored as vectors ----
  float* red = reinterpret_cast<float*>(smem);  // [kKeyWarps][kKeys][red_stride] over the ring
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(red + (warp * kKeys + mt * 16 + g + 8 * half) * plan.red_stride +
                                   nt * 8 + 2 * t4) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
  __syncthreads();
  for (int e = tid; e < kKeys * (DT / 4); e += kKeyThreads) {
    const int r = e / (DT / 4), c4 = e % (DT / 4), j = kt * kKeys + r;
    if (j >= lkv) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(red + (w * kKeys + r) * plan.red_stride + c4 * 4);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    Out<T>::store4(out + ((b * lkv + j) * hkv + h_kv) * head_dim + d0 + c4 * 4, s);
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kKeyThreads)
mot_attention_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ gout,
                              const T* __restrict__ p_in, const float* __restrict__ ds_in,
                              T* __restrict__ dk, T* __restrict__ dv, int lq, int lkv, int hq,
                              int hkv, int head_dim) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int n_dt = head_dim / DT;
  const int which = blockIdx.x % 2;  // 0: dv, 1: dk
  const int d0 = (blockIdx.x / 2) % n_dt * DT;
  const int kt = blockIdx.x / (2 * n_dt);
  if (which == 0) {
    key_block<T, T, DT, kF32, kF32>(p_in, gout, dv, lq, lkv, hq, hkv, head_dim, kt, d0);
  } else {
    key_block<T, float, DT, true, kF32>(ds_in, q, dk, lq, lkv, hq, hkv, head_dim, kt, d0);
  }
}

// Raises an instance's dynamic shared-memory limit to kMaxSmem once per
// device (the attribute belongs to the device's context).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const float* mask, const void* g,
                void* dq, void* p, float* ds, int batch, int lq, int lkv, int hq, int hkv,
                long long mask_sb, long long mask_sq, float scale, float softcap,
                cudaStream_t stream) {
  const RowPlan plan = make_row_plan(sizeof(T), D, lkv);
  if (plan.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem(mot_attention_bwd_rows_kernel<T, D>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (hq / hkv) * lq;
  const dim3 grid((rows + kRows - 1) / kRows, hkv, batch);
  mot_attention_bwd_rows_kernel<T, D><<<grid, kRowThreads, plan.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(p), ds, lq, lkv, hq, hkv,
      mask_sb, mask_sq, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DT>
int launch_keys(const void* q, const void* g, const void* p, const float* ds, void* dk, void* dv,
                int batch, int lq, int lkv, int hq, int hkv, int head_dim, cudaStream_t stream) {
  if (head_dim % DT) return static_cast<int>(cudaErrorInvalidValue);
  const KeyPlan plan = make_key_plan(sizeof(T), DT);
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_smem(mot_attention_bwd_keys_kernel<T, DT>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lkv + kKeys - 1) / kKeys * (head_dim / DT) * 2, hkv, batch);
  mot_attention_bwd_keys_kernel<T, DT><<<grid, kKeyThreads, plan.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), static_cast<const T*>(p), ds,
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lkv, hq, hkv, head_dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(int head_dim, const void* q, const void* k, const void* v, const float* mask,
                  const void* g, void* dq, void* p, float* ds, int batch, int lq, int lkv, int hq,
                  int hkv, long long mask_sb, long long mask_sq, float scale, float softcap,
                  cudaStream_t stream) {
#define OPZ_CASE(DIM)                                                                            \
  if (head_dim == DIM)                                                                           \
    return launch_rows<T, DIM>(q, k, v, mask, g, dq, p, ds, batch, lq, lkv, hq, hkv, mask_sb,    \
                               mask_sq, scale, softcap, stream);
  OPZ_CASE(16) OPZ_CASE(32) OPZ_CASE(64) OPZ_CASE(128) OPZ_CASE(256)
#undef OPZ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_keys(int d_tile, const void* q, const void* g, const void* p, const float* ds,
                  void* dk, void* dv, int batch, int lq, int lkv, int hq, int hkv, int head_dim,
                  cudaStream_t stream) {
#define OPZ_CASE(DT)                                                                         \
  if (d_tile == DT)                                                                          \
    return launch_keys<T, DT>(q, g, p, ds, dk, dv, batch, lq, lkv, hq, hkv, head_dim, stream);
  OPZ_CASE(16) OPZ_CASE(32) OPZ_CASE(64)
#undef OPZ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means no softcap. p and
// ds are the scratch, [B, Hkv, G Lq, round_up(Lkv, 32)] in the inputs'
// dtype and fp32. Returns the launch's error (0 on success).
int opz_mot_attention_bwd_rows(int dtype, const void* q, const void* k, const void* v,
                               const float* mask, const void* g, void* dq, void* p, float* ds,
                               int batch, int lq, int lkv, int hq, int hkv, int head_dim,
                               long long mask_sb, long long mask_sq, float scale, float softcap,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_rows<float>(head_dim, q, k, v, mask, g, dq, p, ds, batch, lq, lkv, hq, hkv,
                                mask_sb, mask_sq, scale, softcap, s);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(head_dim, q, k, v, mask, g, dq, p, ds, batch, lq, lkv, hq,
                                        hkv, mask_sb, mask_sq, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// d_tile = min(64, head_dim): the D columns of one block.
int opz_mot_attention_bwd_keys(int dtype, const void* q, const void* g, const void* p,
                               const float* ds, void* dk, void* dv, int batch, int lq, int lkv,
                               int hq, int hkv, int head_dim, int d_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_keys<float>(d_tile, q, g, p, ds, dk, dv, batch, lq, lkv, hq, hkv, head_dim, s);
  if (dtype == 1)
    return dispatch_keys<__nv_bfloat16>(d_tile, q, g, p, ds, dk, dv, batch, lq, lkv, hq, hkv,
                                        head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block: kernel 0, the row side at (head_dim,
// lkv); kernel 1, the key side at d_tile (passed as `lkv_or_d_tile`).
// The wrapper's bwd_smem_bytes mirrors it.
int opz_mot_attention_bwd_smem_bytes(int kernel, int element_size, int head_dim,
                                     int lkv_or_d_tile) {
  if (kernel == 0) return make_row_plan(element_size, head_dim, lkv_or_d_tile).total;
  return make_key_plan(element_size, lkv_or_d_tile).total;
}

const char* opz_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
