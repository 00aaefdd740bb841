// flash_attention.cu - attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:34
// (_flash_kernel, called by flash_attention at :88).  It computes the same
// function, not the same blocks:
//
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / group, j],
//   s[i, j]    = (q[b, h, i] * sm_scale) . k[b, h / group, j]
//
// over the keys j that the masks keep, with
//   q_pos = q_offset + i,  k_pos = j,
//   j < Skv                                    (ragged lengths, always)
//   q_pos >= k_pos                             (causal)
//   q_pos - k_pos < window                     (sliding window, optional)
// and o = 0 for a row that keeps no key.
//
//   q  (B, H, Sq, D), k and v (B, Hkv, Skv, D), o (B, H, Sq, D); row-major,
//   contiguous, all float32; H % Hkv == 0, group = H / Hkv;
//   D in {16, 32, 64, 128, 256}.
//
// This file takes float32 only.  bfloat16 inputs go to the tensor-core
// kernels of csrc/flash_attention_bf16.cu (wgmma prefill, split-KV decode);
// there is no bf16 instantiation here, so no bf16 tensor reaches this
// CUDA-core kernel.
//
// Precision follows the TPU kernel: q is scaled by sm_scale before Q K^T,
// the running max m, sum l and accumulator are float32, p stays float32
// for P V.  The reference's float32 tolerance (2e-5) rules out TF32 and
// bf16 tensor-core products, so the math stays on the CUDA cores.
//
// What bounds it on an H100.  Each query-key pair that the masks keep
// costs 4 D operations (2 D for Q K^T, 2 D for P V); the bytes are q, k, v
// read once and o written once.  A prefill at thousands of tokens does
// hundreds to thousands of operations per byte, so it is bound by
// operations: float32 on the CUDA cores (67 TFLOP/s).
//
// Design.
//  * Grid (ceil(Sq / 64), H, B): one block of 256 threads per (b, h,
//    64-row q tile).  The TPU's sequential "arbitrary" KV grid axis becomes
//    a loop over KV tiles inside the block; nothing carries between
//    blocks.  K and V are read from KV head h / group, never expanded.
//  * The loop covers only the KV tiles that the causal mask and the window
//    can keep for this q tile; masks inside a tile are applied per score,
//    so a tile that is partly or wholly masked stays inert either way.
//  * No host padding: rows past Sq load zeros and are not stored, keys
//    past Skv are masked.  (The reference pads K and V with zeros and
//    leaves the padded keys unmasked, which changes non-causal results at
//    ragged lengths; the masks here follow ref.attention_ref.)
//  * Masked scores are -inf, and a row whose running max is still -inf
//    adds nothing, so a row that keeps no key ends with l == 0 and
//    returns 0 (not NaN, and not the mean of v).
//  * Thread (ty, tx) owns q rows ty + 16 i (i < 4), score columns
//    tx + 16 j and output columns tx + 16 c; row max and row sum reduce
//    over the 16 lanes of a half-warp with shuffles.  Q and K tiles keep
//    rows padded to D + 4 floats so the float4 reads of a quarter-warp
//    fall in distinct banks.
//  * Tiles are float32 in dynamic shared memory (up to 105 KB at D = 256,
//    raised past the 48 KB static limit with cudaFuncSetAttribute); the KV
//    tile shrinks as D grows (64, 64, 64, 32, 16 keys) to keep the tiles
//    small.  Registers, not shared memory, then limit the blocks an SM
//    holds: ptxas gives 80-124 registers a thread up to D = 128 (two
//    blocks) and 179 at D = 256 (one block).
//
// Interface: a plain C function, loaded with ctypes.  It takes the launch
// geometry that kernels/flash_attention.py's plan chose and refuses one it
// has no instantiation for; it launches on the caller's stream, does not
// synchronise, allocates nothing, reports the kernels it launched, and
// returns cudaGetLastError() after the launch (0 on success).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                  // query rows per block
constexpr int THREADS = 256;            // 16 x 16
constexpr int RPT = BQ / 16;            // query rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Shared-memory layout, in floats: Q tile, K tile, V tile, P tile.
template <int D, int BK>
struct Tiles {
  static constexpr int QK_STRIDE = D + 4;      // padded Q and K rows
  static constexpr int P_STRIDE = BK + 4;      // padded P rows
  static constexpr int Q_FLOATS = BQ * QK_STRIDE;
  static constexpr int K_FLOATS = BK * QK_STRIDE;
  static constexpr int V_FLOATS = BK * D;
  static constexpr int P_FLOATS = BQ * P_STRIDE;
  static constexpr size_t BYTES =
      sizeof(float) * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h,
                       int hkv, int sq, int skv, int causal, int has_window,
                       long long window, long long q_offset, float sm_scale) {
  using L = Tiles<D, BK>;
  constexpr int NC = BK / 16;           // score columns per thread
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + L::Q_FLOATS;
  float* v_s = k_s + L::K_FLOATS;
  float* p_s = v_s + L::V_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int64_t q_base = (static_cast<int64_t>(batch) * h + head) * sq * D;
  const int64_t kv_base =
      (static_cast<int64_t>(batch) * hkv + head / (h / hkv)) * skv * D;

  // Q tile, scaled by sm_scale before Q K^T as the TPU kernel does.
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < sq)
      x = to_f32(q[q_base + static_cast<int64_t>(q0 + r) * D + c]) * sm_scale;
    q_s[r * L::QK_STRIDE + c] = x;
  }

  // Keys [kv_lo, kv_hi) are the only ones the masks can keep for this tile.
  const int rows = min(BQ, sq - q0);
  const long long q_lo = q_offset + q0;
  long long kv_lo = 0, kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, q_lo + rows);
  if (has_window) kv_lo = max(kv_lo, q_lo - window + 1);
  const int t_begin = kv_lo < kv_hi ? static_cast<int>(kv_lo / BK) * BK : 0;
  const int t_end = kv_lo < kv_hi ? static_cast<int>(kv_hi) : 0;

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = t_begin; k0 < t_end; k0 += BK) {
    // K and V tiles; rows past Skv load zeros (their scores are masked).
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv) {
        const int64_t g = kv_base + static_cast<int64_t>(k0 + r) * D + c;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
      }
      k_s[r * L::QK_STRIDE + c] = kx;
      v_s[r * D + c] = vx;
    }
    __syncthreads();

    float s[RPT][NC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &q_s[(ty + 16 * i) * L::QK_STRIDE + d]);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &k_s[(tx + 16 * j) * L::QK_STRIDE + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // Masks, then the online-softmax update of m, l and acc.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const long long qp = q_lo + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long long kp = k0 + tx + 16 * j;
        bool keep = kp < skv;
        if (causal) keep = keep && qp >= kp;
        if (has_window) keep = keep && qp - kp < window;
        if (!keep) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float alpha = 1.f, rs = 0.f;
      if (m_new == -INFINITY) {         // nothing kept yet in this row
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);     // 0 while m[i] is still -inf
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        p_s[(ty + 16 * i) * L::P_STRIDE + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &p_s[(ty + 16 * i) * L::P_STRIDE + kk]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float v0 = v_s[(kk + 0) * D + tx + 16 * c];
        const float v1 = v_s[(kk + 1) * D + tx + 16 * c];
        const float v2 = v_s[(kk + 2) * D + tx + 16 * c];
        const float v3 = v_s[(kk + 3) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          float t = acc[i][c];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][c] = t;
        }
      }
    }
    __syncthreads();
  }

  // A row that kept no key has l == 0 and acc == 0: it returns 0.
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    T* out = o + q_base + static_cast<int64_t>(q0 + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(out + tx + 16 * c, l[i] > 0.f ? acc[i][c] / l[i] : 0.f);
  }
}

// The launch geometry that flash_attention.plan chose (field order as
// AttentionPlan.c_plan in kernels/flash_attention.py).  The library launches
// a plan only when it has an instantiation with exactly that geometry, so
// the plan and the kernels cannot drift apart unnoticed.
struct Plan {
  int path, block_q, block_kv, stages, splits, chunk, smem, gx, gy, gz;
};

bool same_grid(const Plan& p, dim3 g) {
  return p.gx == static_cast<int>(g.x) && p.gy == static_cast<int>(g.y) &&
         p.gz == static_cast<int>(g.z);
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int hkv, int sq, int skv, int causal,
                   int has_window, long long window, long long q_offset,
                   float sm_scale, const Plan& p, int* launched,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, BK>;
  constexpr size_t smem = Tiles<D, BK>::BYTES;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  if (p.path != 0 || p.block_q != BQ || p.block_kv != BK || p.stages != 1 ||
      p.splits != 1 || p.smem != static_cast<int>(smem) || !same_grid(p, grid))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), h, hkv, sq, skv, causal,
      has_window, window, q_offset, sm_scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

// The KV tile per head dim: 64 keys up to D = 64, then 32 and 16.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int h, int hkv, int sq, int skv, int d,
                     int causal, int has_window, long long window,
                     long long q_offset, float sm_scale, const Plan& p,
                     int* launched, cudaStream_t stream) {
#define FA_LAUNCH(D, BK)                                                    \
  launch<T, D, BK>(q, k, v, o, b, h, hkv, sq, skv, causal, has_window,      \
                   window, q_offset, sm_scale, p, launched, stream)
  switch (d) {
    case 16: return FA_LAUNCH(16, 64);
    case 32: return FA_LAUNCH(32, 64);
    case 64: return FA_LAUNCH(64, 64);
    case 128: return FA_LAUNCH(128, 32);
    case 256: return FA_LAUNCH(256, 16);
    default: return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace

// Launches the plan's one kernel on `stream`; *launched counts the kernels
// this call launched (0 or 1).  Returns a cudaError_t, 0 on success.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int sq, int skv, int d, int causal, int has_window,
    long long window, long long q_offset, float sm_scale, const void* plan,
    int* launched, void* stream) {
  *launched = 0;
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv < 0 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<float>(
      q, k, v, o, b, h, hkv, sq, skv, d, causal, has_window, window,
      q_offset, sm_scale, *static_cast<const Plan*>(plan), launched,
      static_cast<cudaStream_t>(stream)));
}
