// Softcapped, masked GQA/MQA attention forward for Hopper (sm_90a):
//
//   out = softmax(tanh(q k^T * scale / softcap) * softcap + mask) v
//
// Replaces open_pi_zero_tpu/ops/pallas_attention.py::_fused_fwd (kernel body
// `_kernel`), the joint mixture-of-transformers attention of every trunk
// layer. Same numerics as the JAX kernel: q k^T accumulates in fp32; scale,
// softcap, the additive fp32 mask and an exact softmax (max, exp, sum,
// divide) run in fp32; p is normalised by its row's full max and sum and
// then rounded to V's dtype before p v, which accumulates in fp32; the
// output is rounded to q's dtype.
//
// Layout: q [B, Lq, Hq, D], k/v [B, Lkv, Hkv, D], out like q, all
// contiguous; mask [B, 1, Lq, Lkv] fp32 with a unit last stride and the
// batch and row strides passed in (the prefix and action masks are views).
//
// Design. The GQA group is folded into the query rows, as on the TPU: row i
// of kv head h is query position i / G of query head h * G + i % G, so the
// G rows of one position are G * D contiguous elements of q and out. A
// cell is kRows = 16 or 64 folded rows of one (batch, kv head). A cell's
// Lkv axis is split into `split` slices of ceil(Lkv / split) keys, one per
// block of a thread block cluster (split in {1, 2, 4, 8, 16}; 16 needs the
// non-portable cluster size). The caller picks kRows and split
// (ops/fused_attention.py::launch_geometry) so that the latency-bound
// shapes spread over many SMs while the grid stays one wave: an Euler step
// (32 rows, Lkv = 281) runs 2 cells x 16 blocks where the TPU ran one
// program, prefill 35 cells x 4, the fp32 training shape 576 cells x 1.
//
// A block streams its slice's K tiles and then its V tiles (kKeys = 32 rows
// each) through a two-stage shared-memory ring with 16-byte cp.async
// copies, so the copy of tile j + 1 overlaps the products on tile j (and
// the first V tile's copy overlaps the softmax). Its slice's fp32 scores
// stay in shared memory. Each block takes its slice's row max m_b and sum
// l_b = sum exp(s - m_b); one exchange through distributed shared memory
// (cluster.map_shared_rank) gives every block M = max m_b and
// L = sum_b l_b exp(m_b - M), added in rank order; each block then
// normalises p = exp(s - m_b) exp(m_b - M) / L by the row's global max and
// sum and only then rounds it to V's dtype, which keeps the JAX kernel's
// cast point (no unnormalised flash-decoding rescale after the cast). Each
// block's fp32 partial p v goes to its shared memory; block r then sums
// rows [r * kRows / split, ...) over the cluster's blocks in rank order
// and stores them as 16-byte (fp32) or 8-byte (bf16) vectors; a block that
// holds whole rows (split 1) stores from its accumulators. No atomics: the
// sum order is fixed, so two calls on the same inputs are bitwise equal.
//
// Products. bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands
// from padded shared tiles by ldmatrix (V through ldmatrix.trans); the
// scores go from the accumulator fragments through scale, softcap and mask
// to the score tile. fp32: the JAX kernel asks for Precision.HIGHEST, so
// plain TF32 is out; this path takes 3xTF32 on the tensor cores (m16n8k8,
// a_big b_big + a_big b_small + a_small b_big, each operand cut into its
// top 10 mantissa bits and the next 10), chosen over a register-tiled FMA
// path because it runs on the tensor cores and shares the bf16 path's
// structure. The dropped a_small b_small term and the cut are about 2^-20
// relative, which holds 1e-4 against the plain version at every shape of
// tests/test_torch_kernel.py (max|diff| about 4e-6 at the training shape
// on an H100). Q k^T keeps separate accumulators per k-step parity (and for
// the small terms), so the mma chains overlap.
//
// What bounds it. The main path's shapes are small: an Euler step moves
// about 0.33 MB for 0.07 GFLOP, prefill 2.9 MB for 0.63 GFLOP, so they
// are bound by latency, not by bytes or operations: a block's dependent
// chain of copy, q k^T, softmax with one cluster exchange, p v and the
// cluster's sum, each one to a few thousand cycles (clock64 stamps on an
// H100: about 16,000 cycles for an Euler block, 39,000 for a prefill
// block, whose three K tiles each wait for their copy).
// The fp32 training shape (10.35 GFLOP) runs one 16-warp block per SM
// (209 KB of shared memory) over 4.4 waves; its 3xTF32 q k^T is bound by
// shared-memory fragment loads and the TF32 split at that occupancy, not
// by the tensor cores.
//
// Limits: D in {16, 32, 64, 128, 256}; the slice's scores take
// kRows * 4 bytes per key of shared memory (plus kRows * 2 for bf16 p)
// beside the q rows and the ring, which bounds Lkv (max_lkv in the
// wrapper: 2816 at D = 256, slices of split <= 8 blocks). Padded keys are
// masked by bounds, never by a fill value, and padded V rows are
// zero-filled: a fully masked row (every mask entry MASK_NEG) comes out as
// the uniform average of its V rows over the real Lkv, finite, like the
// JAX path.

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kKeys = 32;       // K/V rows per ring stage
constexpr int kMaxSplit = 16;   // blocks per cluster
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use on Hopper

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of one block, in bytes; mirrored by
// ops/fused_attention.py::smem_bytes.
struct Plan {
  int q_stride, k_stride, v_stride, s_stride, p_stride, o_stride;
  int q_off, ring_off, s_off, p_off, stat_off, total;
};

__host__ __device__ inline Plan make_plan(int esize, int d, int rows, int slice) {
  Plan p;
  const int pad = 16 / esize;
  const int slice_pad = round_up(slice, kKeys);
  p.q_stride = d + pad;
  p.k_stride = d + (esize == 4 ? 4 : 8);  // conflict-free B fragments
  p.v_stride = d + 8;
  p.s_stride = slice_pad + 4;
  p.p_stride = slice_pad + 8;  // bf16 p
  p.o_stride = d + 4;
  const int q_and_ring = rows * p.q_stride * esize + 2 * kKeys * p.v_stride * esize;
  const int partial_out = rows * p.o_stride * 4;  // overlays q and the ring at the end
  p.q_off = 0;
  p.ring_off = rows * p.q_stride * esize;
  p.s_off = q_and_ring > partial_out ? q_and_ring : partial_out;
  p.p_off = p.s_off + rows * p.s_stride * 4;
  p.stat_off = p.p_off + (esize == 2 ? rows * p.p_stride * 2 : 0);
  p.total = p.stat_off + 2 * rows * 4;
  return p;
}

// ---- PTX helpers ----

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, each a TF32 value (the top 10 mantissa bits, cut by a
// mask: two integer ops instead of two conversions).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// big += a_big b_big and small += a_small b_big + a_big b_small, in TF32
// from fp32 fragments a [4], b [2]; big and small may be one accumulator.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bb[i], bs[i]);
  mma_tf32(small, as, bb);
  mma_tf32(small, ab, bs);
  mma_tf32(big, ab, bb);
}

template <typename T> struct Out;
template <> struct Out<float> {
  // 4 fp32 values as one 16-byte store, 2 as one 8-byte store
  static __device__ __forceinline__ void store4(float* dst, float4 x) {
    *reinterpret_cast<float4*>(dst) = x;
  }
  static __device__ __forceinline__ void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
};
template <> struct Out<__nv_bfloat16> {
  // 4 values as one 8-byte store
  static __device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  }
  // 2 values as one 4-byte store
  static __device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
};

template <typename T, int D, int kRows>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWarpsM = kRows / 16;  // a warp owns 16 rows
  // warps over keys / D: 4, but 2 for 64 bf16 rows, whose 256 threads let
  // two blocks share an SM at prefill; 64 fp32 rows take 512 threads, as
  // their 209 KB of shared memory leave one block per SM
  static constexpr int kWarpsN = kRows == 64 && kBf16 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kScoreTiles = kKeys / 8 / kWarpsN;            // n8 key tiles a warp scores
  static constexpr int kOutTiles = (D / 8 + kWarpsN - 1) / kWarpsN;  // n8 tiles of D a warp sums
  static constexpr int kChunk = 16 / sizeof(T);                      // elements per 16-byte copy
  static_assert(D % 16 == 0 && D <= 256, "head dim must be 16..256, a multiple of 16");
};

template <typename T, int D, int kRows>
__global__ void __launch_bounds__(Cfg<T, D, kRows>::kThreads)
mot_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ mask,
                         T* __restrict__ out, int lq, int lkv, int hq, int hkv,
                         long long mask_sb, long long mask_sq, float scale, float softcap,
                         int split) {
  using C = Cfg<T, D, kRows>;
  constexpr int kThreads = C::kThreads, kChunk = C::kChunk, kCopies = D / kChunk;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  extern __shared__ __align__(128) unsigned char smem[];
  const int slice = (lkv + split - 1) / split;
  const Plan plan = make_plan(sizeof(T), D, kRows, slice);
  T* qs = reinterpret_cast<T*>(smem + plan.q_off);
  T* ring = reinterpret_cast<T*>(smem + plan.ring_off);
  float* sc = reinterpret_cast<float*>(smem + plan.s_off);              // [kRows][s_stride]
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + plan.p_off);  // bf16 p
  float* rmax = reinterpret_cast<float*>(smem + plan.stat_off);
  float* rsum = rmax + kRows;

  const int group = hq / hkv;
  const int row0 = (blockIdx.x / split) * kRows;
  const int n_rows = min(kRows, group * lq - row0);
  const int h_kv = blockIdx.y;
  const long long b = blockIdx.z;
  const int kv0 = rank * slice;
  const int n_keys = max(0, min(slice, lkv - kv0));
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int g = lane / 4, t4 = lane % 4;
  const float* mask_b = mask + b * mask_sb;

  // ---- q rows, then the K tiles and V tiles of the slice through the ring ----
  // Thread t copies 16-byte chunk t % kCopies of every kStep-th row.
  constexpr int kStep = kThreads / kCopies;
  const int c_own = tid % kCopies;
  for (int r = tid / kCopies; r < kRows; r += kStep) {
    const T* src = q;
    int bytes = 0;
    if (r < n_rows) {
      const int i = row0 + r, qi = i / group, h = h_kv * group + i % group;
      src = q + ((b * lq + qi) * hq + h) * D + c_own * kChunk;
      bytes = 16;
    }
    cp_async16(qs + r * plan.q_stride + c_own * kChunk, src, bytes);
  }
  const long long kv_row = static_cast<long long>(hkv) * D;  // elements between keys
  auto load_tile = [&](int i) {  // i < n_tiles: K tile i, else V tile i - n_tiles
    const bool is_k = i < n_tiles;
    const int stride = is_k ? plan.k_stride : plan.v_stride;
    const int j0 = kv0 + (is_k ? i : i - n_tiles) * kKeys;
    const T* src = (is_k ? k : v) + (b * lkv * hkv + h_kv) * D + c_own * kChunk;
    T* dst = ring + (i & 1) * kKeys * plan.v_stride + c_own * kChunk;
    for (int jj = tid / kCopies; jj < kKeys; jj += kStep) {
      const bool ok = j0 + jj < kv0 + n_keys;  // rows past the slice are zero-filled
      cp_async16(dst + jj * stride, ok ? src + (j0 + jj) * kv_row : k, ok ? 16 : 0);
    }
  };
  const int total = 2 * n_tiles;
  if (total > 0) load_tile(0);
  cp_async_commit();

  // ---- scores: s = tanh(q k^T * scale / softcap) * softcap + mask ----
  for (int i = 0; i < n_tiles; ++i) {
    load_tile(i + 1);  // the next K tile, or V tile 0 during the softmax
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = ring + (i & 1) * kKeys * plan.v_stride;
    // this thread's mask entries, read before the products hide their latency
    float mk[C::kScoreTiles][4];
#pragma unroll
    for (int nt = 0; nt < C::kScoreTiles; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = wm * 16 + g + 8 * (x / 2);
        const int jl = i * kKeys + (wn * C::kScoreTiles + nt) * 8 + 2 * t4 + x % 2;
        mk[nt][x] = r < n_rows && jl < n_keys
                        ? mask_b[static_cast<long long>((row0 + r) / group) * mask_sq + kv0 + jl]
                        : 0.f;
      }
    }
    // independent accumulators, summed at the end, so that the mma chains
    // overlap: [k step parity] for bf16; [big, small][parity] for fp32
    float c[4][C::kScoreTiles][4] = {};
    if constexpr (C::kBf16) {
      constexpr int kSteps = D / 16;
#pragma unroll 2
      for (int k2 = 0; k2 < kSteps; k2 += 2) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int ks = k2 + par;
          if (ks >= kSteps) break;
          uint32_t a[4];
          ldmatrix_x4(a, qs + (wm * 16 + lane % 16) * plan.q_stride + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int nt = 0; nt < C::kScoreTiles; ++nt) {
            const int n0 = (wn * C::kScoreTiles + nt) * 8;
            uint32_t bb[2];
            ldmatrix_x2(bb, tile + (n0 + lane % 8) * plan.k_stride + ks * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(c[par][nt], a, bb);
          }
        }
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(qs);
      const float* kf = reinterpret_cast<const float*>(tile);
      constexpr int kSteps = D / 8;
#pragma unroll 2
      for (int k2 = 0; k2 < kSteps; k2 += 2) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int ks = k2 + par;
          const float* qr = qf + (wm * 16 + g) * plan.q_stride + ks * 8 + t4;
          const float a[4] = {qr[0], qr[8 * plan.q_stride], qr[4], qr[8 * plan.q_stride + 4]};
#pragma unroll
          for (int nt = 0; nt < C::kScoreTiles; ++nt) {
            const float* kr = kf + ((wn * C::kScoreTiles + nt) * 8 + g) * plan.k_stride + ks * 8 + t4;
            const float bb[2] = {kr[0], kr[4]};
            mma_3xtf32(c[par][nt], c[2 + par][nt], a, bb);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < C::kScoreTiles; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        c[0][nt][x] = (c[2][nt][x] + c[3][nt][x]) + (c[0][nt][x] + c[1][nt][x]);
#pragma unroll
    for (int nt = 0; nt < C::kScoreTiles; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = wm * 16 + g + 8 * (x / 2);
        const int jl = i * kKeys + (wn * C::kScoreTiles + nt) * 8 + 2 * t4 + x % 2;
        if (jl >= n_keys) continue;
        float s = 0.f;
        if (r < n_rows) {
          s = c[0][nt][x] * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          s += mk[nt][x];
        }
        sc[r * plan.s_stride + jl] = s;
      }
    }
    __syncthreads();  // the stage is consumed before the load into it
  }

  // ---- softmax over the cluster: the row's global max and sum ----
  // kTpr threads take one row, each every kTpr-th 4-key chunk of it, so a
  // thread's loop runs over independent 16-byte loads. A block exchanges
  // its slice's max m_b and sum l_b = sum exp(s - m_b) once; then
  // M = max m_b and L = sum_b l_b exp(m_b - M) in rank order, and
  // p = exp(s - m_b) exp(m_b - M) / L, normalised before the cast.
  constexpr int kTpr = kThreads / kRows;  // 8 or 4, lanes of one warp
  const int sr = tid / kTpr, part_i = tid % kTpr;
  const unsigned row_lanes = lane & ~(kTpr - 1);
  float* srow = sc + sr * plan.s_stride;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  float m = neg_inf;
  for (int j = 4 * part_i; j < n_keys; j += 4 * kTpr) {
    const float4 x = *reinterpret_cast<const float4*>(srow + j);
    m = fmaxf(m, x.x);
    if (j + 1 < n_keys) m = fmaxf(m, x.y);
    if (j + 2 < n_keys) m = fmaxf(m, x.z);
    if (j + 3 < n_keys) m = fmaxf(m, x.w);
  }
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int j = 4 * part_i; j < n_keys; j += 4 * kTpr) {
    float4 x = *reinterpret_cast<const float4*>(srow + j);
    x.x = expf(x.x - m);
    x.y = j + 1 < n_keys ? expf(x.y - m) : 0.f;
    x.z = j + 2 < n_keys ? expf(x.z - m) : 0.f;
    x.w = j + 3 < n_keys ? expf(x.w - m) : 0.f;
    *reinterpret_cast<float4*>(srow + j) = x;
    sum += x.x + x.y + x.z + x.w;
  }
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (part_i == 0) {
    rmax[sr] = m;
    rsum[sr] = sum;
  }
  cluster.sync();
  float peer_m[kMaxSplit / kTpr], peer_l[kMaxSplit / kTpr];
#pragma unroll
  for (int k = 0; k < kMaxSplit / kTpr; ++k) {
    const int p = part_i + k * kTpr;
    peer_m[k] = p < split ? cluster.map_shared_rank(rmax, p)[sr] : neg_inf;
    peer_l[k] = p < split ? cluster.map_shared_rank(rsum, p)[sr] : 0.f;
  }
  float gmax = neg_inf;
#pragma unroll
  for (int k = 0; k < kMaxSplit / kTpr; ++k) gmax = fmaxf(gmax, peer_m[k]);
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
  // block p's term l_p exp(m_p - M), computed by the lane that read it,
  // then added in rank order: the same in every block and run
#pragma unroll
  for (int k = 0; k < kMaxSplit / kTpr; ++k)
    peer_l[k] = peer_l[k] > 0.f ? peer_l[k] * expf(peer_m[k] - gmax) : 0.f;
  float gsum = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxSplit; ++p)
    if (p < split) gsum += __shfl_sync(0xffffffffu, peer_l[p / kTpr], row_lanes | (p % kTpr));
  const float scale_b = sum > 0.f ? expf(m - gmax) : 0.f;  // exp(m_b - M)
  for (int j = 4 * part_i; j < n_tiles * kKeys; j += 4 * kTpr) {
    float4 x = *reinterpret_cast<const float4*>(srow + j);
    x.x = j < n_keys ? x.x * scale_b / gsum : 0.f;
    x.y = j + 1 < n_keys ? x.y * scale_b / gsum : 0.f;
    x.z = j + 2 < n_keys ? x.z * scale_b / gsum : 0.f;
    x.w = j + 3 < n_keys ? x.w * scale_b / gsum : 0.f;
    if constexpr (C::kBf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(ps + sr * plan.p_stride + j) = u;
    } else {
      *reinterpret_cast<float4*>(srow + j) = x;
    }
  }
  __syncthreads();

  // ---- partial out = p v over the slice, fp32 accumulation ----
  float acc[C::kOutTiles][4] = {};
  for (int i = n_tiles; i < total; ++i) {
    if (i + 1 < total) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* tile = ring + (i & 1) * kKeys * plan.v_stride;
    const int j0 = (i - n_tiles) * kKeys;
    if constexpr (C::kBf16) {
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, ps + (wm * 16 + lane % 16) * plan.p_stride + j0 + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int ot = 0; ot < C::kOutTiles; ++ot) {
          const int n8 = wn + ot * C::kWarpsN;
          if (n8 >= D / 8) continue;
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, tile + (ks * 16 + lane % 16) * plan.v_stride + n8 * 8);
          mma_bf16(acc[ot], a, bb);
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(tile);
#pragma unroll
      for (int ks = 0; ks < kKeys / 8; ++ks) {
        const float* pr = sc + (wm * 16 + g) * plan.s_stride + j0 + ks * 8 + t4;
        const float a[4] = {pr[0], pr[8 * plan.s_stride], pr[4], pr[8 * plan.s_stride + 4]};
#pragma unroll
        for (int ot = 0; ot < C::kOutTiles; ++ot) {
          const int n8 = wn + ot * C::kWarpsN;
          if (n8 >= D / 8) continue;
          const float* vr = vf + (ks * 8 + t4) * plan.v_stride + n8 * 8 + g;
          const float bb[2] = {vr[0], vr[4 * plan.v_stride]};
          mma_3xtf32(acc[ot], acc[ot], a, bb);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  if (split == 1) {  // the block holds whole rows: store from the accumulators
#pragma unroll
    for (int ot = 0; ot < C::kOutTiles; ++ot) {
      const int n8 = wn + ot * C::kWarpsN;
      if (n8 >= D / 8) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 + g + 8 * half;
        if (r >= n_rows) continue;
        const int i = row0 + r, qi = i / group, h = h_kv * group + i % group;
        Out<T>::store2(out + ((b * lq + qi) * hq + h) * D + n8 * 8 + 2 * t4, acc[ot][2 * half],
                       acc[ot][2 * half + 1]);
      }
    }
    return;
  }

  // ---- the cluster's partials summed in rank order into 16-byte stores ----
  float* part = reinterpret_cast<float*>(smem);  // [kRows][o_stride] over q and the ring
#pragma unroll
  for (int ot = 0; ot < C::kOutTiles; ++ot) {
    const int n8 = wn + ot * C::kWarpsN;
    if (n8 >= D / 8) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + g + 8 * half;
      *reinterpret_cast<float2*>(part + r * plan.o_stride + n8 * 8 + 2 * t4) =
          make_float2(acc[ot][2 * half], acc[ot][2 * half + 1]);
    }
  }
  cluster.sync();
  const int rows_per = kRows / split;
  for (int e = tid; e < rows_per * (D / 4); e += kThreads) {
    const int r = rank * rows_per + e / (D / 4), c4 = e % (D / 4);
    if (r >= n_rows) continue;
    float4 x[kMaxSplit];  // every peer's load in flight at once
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      if (p < split)
        x[p] = *reinterpret_cast<const float4*>((p == rank ? part : cluster.map_shared_rank(part, p)) +
                                                r * plan.o_stride + c4 * 4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      if (p < split) {
        s.x += x[p].x;
        s.y += x[p].y;
        s.z += x[p].z;
        s.w += x[p].w;
      }
    }
    const int i = row0 + r, qi = i / group, h = h_kv * group + i % group;
    Out<T>::store4(out + ((b * lq + qi) * hq + h) * D + c4 * 4, s);
  }
  cluster.sync();  // no block leaves while a peer reads its shared memory
}

// Raises the instance's dynamic shared-memory limit to kMaxSmem and allows
// clusters of 16 blocks, once per device (the attributes belong to the
// device's context), so a launch makes no extra driver call.
template <typename T, int D, int kRows>
cudaError_t set_attributes() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  auto kernel = mot_attention_fwd_kernel<T, D, kRows>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D, int kRows>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           int batch, int lq, int lkv, int hq, int hkv, long long mask_sb,
           long long mask_sq, float scale, float softcap, int split, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) || kRows % split)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(sizeof(T), D, kRows, (lkv + split - 1) / split);
  if (plan.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_attributes<T, D, kRows>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (hq / hkv) * lq;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((rows + kRows - 1) / kRows) * split, hkv, batch);
  config.blockDim = dim3(Cfg<T, D, kRows>::kThreads);
  config.dynamicSmemBytes = plan.total;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, mot_attention_fwd_kernel<T, D, kRows>,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), mask, static_cast<T*>(out), lq, lkv, hq,
                           hkv, mask_sb, mask_sq, scale, softcap, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, int rows_per_block, const void* q, const void* k, const void* v,
             const float* mask, void* out, int batch, int lq, int lkv, int hq, int hkv,
             long long mask_sb, long long mask_sq, float scale, float softcap, int split,
             cudaStream_t stream) {
#define OPZ_CASE(DIM, ROWS)                                                             \
  if (head_dim == DIM && rows_per_block == ROWS)                                        \
    return launch<T, DIM, ROWS>(q, k, v, mask, out, batch, lq, lkv, hq, hkv, mask_sb,   \
                                mask_sq, scale, softcap, split, stream);
  OPZ_CASE(16, 16) OPZ_CASE(32, 16) OPZ_CASE(64, 16) OPZ_CASE(128, 16) OPZ_CASE(256, 16)
  OPZ_CASE(16, 64) OPZ_CASE(32, 64) OPZ_CASE(64, 64) OPZ_CASE(128, 64) OPZ_CASE(256, 64)
#undef OPZ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means no softcap.
// rows_per_block in {16, 64} and split (blocks per cluster, a power of two
// <= 16) are the launch geometry. Returns the launch's error (0 on success).
int opz_mot_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                          const float* mask, void* out, int batch, int lq, int lkv, int hq,
                          int hkv, int head_dim, long long mask_sb, long long mask_sq,
                          float scale, float softcap, int rows_per_block, int split,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(head_dim, rows_per_block, q, k, v, mask, out, batch, lq, lkv, hq,
                           hkv, mask_sb, mask_sq, scale, softcap, split, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(head_dim, rows_per_block, q, k, v, mask, out, batch, lq,
                                   lkv, hq, hkv, mask_sb, mask_sq, scale, softcap, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel, launched to measure the launch floor.
int opz_empty_launch(void* stream);

// Dynamic shared memory of one block (make_plan), which the wrapper's
// smem_bytes mirrors.
int opz_mot_attention_smem_bytes(int element_size, int head_dim, int rows, int slice) {
  return make_plan(element_size, head_dim, rows, slice).total;
}

const char* opz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

namespace {
__global__ void opz_empty_kernel() {}
}  // namespace

extern "C" int opz_empty_launch(void* stream) {
  opz_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
