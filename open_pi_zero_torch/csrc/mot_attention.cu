// Softcapped, masked GQA/MQA attention forward for Hopper (sm_90a):
//
//   out = softmax(tanh(q k^T * scale / softcap) * softcap + mask) v
//
// Replaces open_pi_zero_tpu/ops/pallas_attention.py::_fused_fwd (kernel body
// `_kernel`), the joint mixture-of-transformers attention of every trunk
// layer. Same numerics as the JAX kernel: q k^T accumulates in fp32; scale,
// softcap, the additive fp32 mask and an exact softmax (max, exp, sum,
// divide) run in fp32; the probabilities are rounded to V's dtype before
// p v, which accumulates in fp32; the output is rounded to q's dtype.
//
// Layout: q [B, Lq, Hq, D], k/v [B, Lkv, Hkv, D], out like q, all
// contiguous; mask [B, 1, Lq, Lkv] fp32 with a unit last stride and the
// batch and row strides passed in (the prefix and action masks are views).
//
// Design. The GQA group is folded into the query rows, as on the TPU: row i
// of kv head h is query position i / G of query head h * G + i % G. One
// block takes kRows = 16 folded rows of one (batch, kv head): 139 blocks for
// the prefill shape (G * Lq = 8 * 277 rows) and 2 for an Euler step
// (8 * 4 rows), where the TPU ran one program per (batch, kv head). The
// block keeps its rows' scores for all Lkv columns in shared memory, so the
// softmax is exact and row-resident (no online rescaling) and the cast
// points are those of the JAX kernel. K and then V stream through one
// shared tile of kKeys = 64 rows, converted to fp32.
//
// What bounds it. At the main path's shapes the kernel moves about 2.9 MB
// (prefill) or 0.33 MB (Euler step) for 0.63 or 0.07 GFLOP: a tensor-core
// kernel would be bound by bytes. This one does its products with scalar
// fp32 FMAs, so it is bound by the FMA and shared-memory issue rate of the
// few SMs it occupies: 2 of 132 at the Euler shape. The q k^T loop gives
// each thread a 2-row x 2-key tile read as float4 along D (10 shared-memory
// wavefronts per 16 FMA instructions); p v gives each thread one column of
// D for kRows / (256 / D) rows and reads p as float4 broadcasts, which
// leaves it FMA-bound. Tensor cores (mma/wgmma) and a split over Lkv for
// the 2-block Euler shape are the next steps.
//
// Limits: D in {16, 32, 64, 128, 256}; the scores take 64 * round4(Lkv)
// bytes of shared memory beside the q rows and the tile, so at D = 256 the
// 227 KB a block may use allows Lkv <= 2336 (the main path needs 281).
// Padded columns are masked by bounds, never by a fill value: a fully
// masked row (every mask entry MASK_NEG) comes out as the uniform average
// of its V rows, finite, like the JAX path.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;     // folded query rows per block
constexpr int kKeys = 64;     // K/V rows per shared tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// K or V rows [j0, j0 + kKeys) of one (batch, kv head) into the fp32 tile;
// rows past Lkv are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* tile, int b,
                                          int h_kv, int hkv, int lkv, int j0) {
  constexpr int kStride = D + 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
    const int jj = e / D, d = e - jj * D;
    const int j = j0 + jj;
    float x = 0.f;
    if (j < lkv) x = to_float(src[((static_cast<long long>(b) * lkv + j) * hkv + h_kv) * D + d]);
    tile[jj * kStride + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mot_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ mask,
                         T* __restrict__ out, int lq, int lkv, int hq, int hkv,
                         long long mask_sb, long long mask_sq, float scale,
                         float softcap) {
  static_assert(D % 16 == 0 && D <= kThreads, "head dim must be 16..256, a multiple of 16");
  constexpr int kStride = D + 4;               // tile row stride: odd count of float4s
  constexpr int kGroups = kThreads / D;        // p v: row groups of threads
  constexpr int kRowsPerThread = kRows / kGroups;
  static_assert(kRows % kGroups == 0, "rows must split over the row groups");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  float* tile = qs + kRows * D;                  // [kKeys][kStride]
  float* sc = tile + kKeys * kStride;            // [kRows][lkv_pad]
  const int lkv_pad = (lkv + 3) & ~3;

  const int group = hq / hkv;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, group * lq - row0);
  const int h_kv = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;

  for (int e = t; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float x = 0.f;
    if (r < n_rows) {
      const int i = row0 + r;
      const int qi = i / group, h = h_kv * group + (i - qi * group);
      x = to_float(q[((static_cast<long long>(b) * lq + qi) * hq + h) * D + d]);
    }
    qs[e] = x;
  }

  // ---- scores: s = tanh(q k^T * scale / softcap) * softcap + mask ----
  const int r0 = 2 * (t / 32);  // this thread's rows r0, r0 + 1
  const int kp = t % 32;        // and tile keys kp, kp + 32
  const float* mask_b = mask + b * mask_sb;
  for (int j0 = 0; j0 < lkv; j0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    load_tile<T, D>(k, tile, b, h_kv, hkv, lkv, j0);
    __syncthreads();
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const float4* qa = reinterpret_cast<const float4*>(qs + r0 * D);
    const float4* qb = reinterpret_cast<const float4*>(qs + (r0 + 1) * D);
    const float4* ka = reinterpret_cast<const float4*>(tile + kp * kStride);
    const float4* kb = reinterpret_cast<const float4*>(tile + (kp + 32) * kStride);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 x0 = qa[c], x1 = qb[c], y0 = ka[c], y1 = kb[c];
      acc[0][0] = dot4(x0, y0, acc[0][0]);
      acc[0][1] = dot4(x0, y1, acc[0][1]);
      acc[1][0] = dot4(x1, y0, acc[1][0]);
      acc[1][1] = dot4(x1, y1, acc[1][1]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = r0 + rr, j = j0 + kp + 32 * kk;
        if (j >= lkv) continue;
        float s = 0.f;
        if (r < n_rows) {
          s = acc[rr][kk] * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          s += mask_b[static_cast<long long>((row0 + r) / group) * mask_sq + j];
        }
        sc[r * lkv_pad + j] = s;
      }
    }
  }
  __syncthreads();

  // ---- exact fp32 softmax per row, p rounded to V's dtype ----
  const int warp = t / 32, lane = t % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* srow = sc + r * lkv_pad;
    if (r >= n_rows) {
      for (int j = lane; j < lkv_pad; j += 32) srow[j] = 0.f;
      continue;
    }
    float m = __int_as_float(static_cast<int>(0xff800000u));  // -inf
    for (int j = lane; j < lkv; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < lkv; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < lkv_pad; j += 32)
      srow[j] = j < lkv ? to_float(from_float<T>(srow[j] / sum)) : 0.f;
  }

  // ---- out = p v, fp32 accumulation ----
  const int d = t % D;
  const int rg = t / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < lkv; j0 += kKeys) {
    __syncthreads();  // softmax done / the previous tile is consumed
    load_tile<T, D>(v, tile, b, h_kv, hkv, lkv, j0);
    __syncthreads();
    const int n = min(kKeys, lkv_pad - j0);  // a multiple of 4
    for (int jj = 0; jj < n; jj += 4) {
      const float v0 = tile[jj * kStride + d];
      const float v1 = tile[(jj + 1) * kStride + d];
      const float v2 = tile[(jj + 2) * kStride + d];
      const float v3 = tile[(jj + 3) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 p =
            *reinterpret_cast<const float4*>(sc + (rg + i * kGroups) * lkv_pad + j0 + jj);
        acc[i] = fmaf(p.x, v0, acc[i]);
        acc[i] = fmaf(p.y, v1, acc[i]);
        acc[i] = fmaf(p.z, v2, acc[i]);
        acc[i] = fmaf(p.w, v3, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + i * kGroups;
    if (r >= n_rows) continue;
    const int row = row0 + r;
    const int qi = row / group, h = h_kv * group + (row - qi * group);
    out[((static_cast<long long>(b) * lq + qi) * hq + h) * D + d] = from_float<T>(acc[i]);
  }
}

size_t smem_bytes(int head_dim, int lkv) {
  return sizeof(float) * (static_cast<size_t>(kRows) * head_dim +
                          static_cast<size_t>(kKeys) * (head_dim + 4) +
                          static_cast<size_t>(kRows) * ((lkv + 3) & ~3));
}

// Dynamic shared memory one block may use on Hopper (227 KB); the wrapper's
// MAX_SMEM_BYTES.
constexpr int kMaxSmem = 232448;

// Raises the kernel instance's dynamic shared-memory limit to kMaxSmem once
// per device (the attribute belongs to the device's context), so a launch
// makes no extra driver call.
template <typename T, int D>
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};  // bit i: device i is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(mot_attention_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           int batch, int lq, int lkv, int hq, int hkv, long long mask_sb,
           long long mask_sq, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, lkv);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_max_smem<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = mot_attention_fwd_kernel<T, D>;
  const int rows = (hq / hkv) * lq;
  const dim3 grid((rows + kRows - 1) / kRows, hkv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), lq, lkv, hq, hkv, mask_sb, mask_sq, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                      const float* mask, void* out, int batch, int lq, int lkv, int hq,
                      int hkv, long long mask_sb, long long mask_sq, float scale,
                      float softcap, cudaStream_t stream) {
#define OPZ_CASE(DIM)                                                                  \
  case DIM:                                                                            \
    return launch<T, DIM>(q, k, v, mask, out, batch, lq, lkv, hq, hkv, mask_sb, mask_sq, \
                          scale, softcap, stream);
  switch (head_dim) {
    OPZ_CASE(16)
    OPZ_CASE(32)
    OPZ_CASE(64)
    OPZ_CASE(128)
    OPZ_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef OPZ_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means no softcap.
// Returns cudaGetLastError() after the launch (0 on success).
int opz_mot_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                          const float* mask, void* out, int batch, int lq, int lkv, int hq,
                          int hkv, int head_dim, long long mask_sb, long long mask_sq,
                          float scale, float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(head_dim, q, k, v, mask, out, batch, lq, lkv, hq, hkv,
                                    mask_sb, mask_sq, scale, softcap, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, mask, out, batch, lq, lkv,
                                            hq, hkv, mask_sb, mask_sq, scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* opz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
