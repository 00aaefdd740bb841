// flash_attention.cu - float32 attention for Hopper (sm_90a) on the tensor
// cores, with split-TF32 products.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:34
// (_flash_kernel, called by flash_attention at :88) for float32 inputs;
// bfloat16 inputs go to csrc/flash_attention_bf16.cu.  It computes the same
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
//   contiguous, float32, 16-byte aligned; H % Hkv == 0, group = H / Hkv;
//   D in {16, 32, 64, 128, 192, 256}.
//
// Precision: split-TF32 ("3xTF32").  A TF32 product keeps 10 bits of each
// operand's mantissa, too few for the reference's float32 tolerance
// (atol = rtol = 2e-5): one TF32 product per score misses it at most
// outputs (ref.attention_tf32_ref(terms=1): max |diff| ~1e-3).  So every
// operand x is split into two TF32 values, hi = rna(x) and lo = rna(x - hi)
// (cvt.rna.tf32.f32: round to nearest, ties away from zero), and each
// product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, smallest first,
// on mma.sync m16n8k8 with float32 accumulation; lo.lo is dropped.  hi + lo
// holds x to about 2^-22 relative, and the emulation of this scheme
// (ref.attention_tf32_ref(terms=3)) stays within 2e-5 of the float32
// softmax by two orders of magnitude.  q is scaled by sm_scale * log2(e)
// before its split (the TPU kernel scales q first too; log2 e lets the
// softmax use ex2), the running max m, sum l and accumulator are float32,
// and P is split like the operands before P V.
//
// What bounds it on an H100.  Each query-key pair that the masks keep costs
// 4 D operations (2 D for Q K^T, 2 D for P V), 12 D as three TF32 products;
// the bytes are q, k, v read once and o written once.  A prefill at
// hundreds of keys or more does hundreds of operations per byte, so it is
// bound by operations: 67 TFLOP/s in float32 on the CUDA cores, or 495
// TFLOP/s TF32 on the tensor cores for the three products (165 TFLOP/s of
// float32 work).
//
// Design.
//  * Grid: one-dimensional, one block of WARPS warps per (b, h, q tile of
//    16 * WARPS rows, KV split), every (b, h) of a q tile together and the
//    q tiles heaviest first (causal), so the last wave holds the light ones.
//    Each warp owns 16 q rows; its m, l and accumulator stay in registers,
//    and row max and row sum reduce over the 4 lanes of a quad.
//  * Q: scaled, split and held as A fragments in registers for the whole
//    block (QREG: D / 2 registers a thread), or, where the registers are
//    wanted elsewhere (the accumulator, D / 2 floats a thread, from
//    D = 128), the scaled tile sits in shared memory and each warp splits
//    its own rows' fragments as it reads them.
//  * Tiles, one instantiation a head dim (flash_attention.plan names it):
//    8 warps and 64-key tiles at D = 64, the path's shapes (one block an
//    SM: 229 registers a thread; on an H100, 4 warps with 64 or 32 keys
//    ran 3-5 % slower at whisper-base's split grid, and at lm100m 0.6 %
//    faster with 64 keys, 4 % slower with 32); 4 warps and 64, 32 or 16
//    keys elsewhere (16 at D = 192 and 256; D = 256 takes 255 registers).
//  * K and V tiles of BK keys arrive by 16-byte cp.async into a ring of
//    STAGES slots, STAGES - 1 tiles ahead of the one being multiplied.  When
//    a tile lands the block splits it once: hi in place, lo into one shared
//    lo tile each for K and V, so no warp repeats the conversions.  Rows are
//    D + 4 floats apart, which puts the B-fragment reads of both products
//    (K: 8 keys x 4 columns; V: rows 2t and 2t + 1 of 8 keys x 8 columns)
//    in 32 distinct banks.
//  * S = Q K^T and P V on mma.sync m16n8k8 TF32 (three each, as above).  P
//    stays in registers: the accumulator fragment gives a thread keys 2t
//    and 2t + 1 of each group of 8, the A fragment wants columns t and
//    t + 4, and P V sums over keys, so column t stands for key 2t and
//    column t + 4 for key 2t + 1, and V's B fragment is read at rows 2t and
//    2t + 1.  No shuffle and no shared-memory round trip.
//  * Masks: the causal and window bounds pick the first and last KV tile of
//    the q tile; a warp skips a tile that none of its rows keeps, and only
//    edge tiles apply per-score masks.  Masked scores are -inf and a row
//    whose running max is still -inf adds nothing, so a row that keeps no
//    key ends with l == 0 and returns 0.  Rows past Sq load zeros and are
//    not stored; keys past Skv load zeros and are masked.
//  * KV split: where the q-tile grid does not fill the blocks the card
//    holds at once, flash_attention.plan splits each q tile's KV tiles
//    into `splits` parts (the fewest that minimise waves x tiles a block);
//    each block writes float32 partials and the combine kernel merges them
//    into the float32 output.
//
// lse (optional, float32 (B, H, Sq)): the row's log-sum-exp of the scaled
// scores, ln sum_j exp(s[i, j]) over the kept keys, -inf for a row that
// keeps no key (whose o is 0).  A rank of a sequence-sharded decode gives
// (o, lse) over its slots, and the ranks combine them (serving/engine.py).
// Written by the attention kernel where the keys are not split and by the
// combine kernel where they are, from (m, l) through lse_of: no extra
// launch.  o is float32 either way (csrc/flash_attention_bf16.cu writes a
// float32 o with lse too).
//
// Partials (as csrc/flash_attention_bf16.cu): acc at
// scratch[(split * rows + row) * D + c], then (m, l) pairs at
// scratch[splits * rows * D + (split * rows + row) * 2]; rows = B*H*Sq and
// row = (b * H + h) * Sq + i.  m is in base-2 units (the largest kept
// s * log2 e, -inf where none is kept), l = sum 2^(s log2 e - m).
//
// Interface: a plain C function, loaded with ctypes.  It takes the launch
// geometry that kernels/flash_attention.py's plan chose and refuses one it
// has no instantiation for; it launches on the caller's stream (one kernel,
// or two where the keys are split), does not synchronise, allocates
// nothing, reports the kernels it launched, and returns cudaGetLastError()
// after the launch (0 on success).  A null lse pointer writes no lse.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A row's log-sum-exp from its base-2 running max m (the largest kept
// s * log2 e) and sum l = sum 2^(s log2 e - m): ln(2^m l); -inf where the
// row kept no key (l == 0).
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : -INFINITY;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float tf32(float x) {    // rna(x), as a float
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// x = hi + lo, both TF32 values (low 13 mantissa bits zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(x - h));
}

// c += a (16x8, row) * b (8x8, col): TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, smallest first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ float ex2(float x) {     // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool kept(long long qp, long long kp, int skv,
                                     int causal, int has_window,
                                     long long window) {
  return kp < skv && (!causal || qp >= kp) &&
         (!has_window || qp - kp < window);
}

__device__ __forceinline__ uint32_t u32(float x) { return __float_as_uint(x); }

// Shared memory, in floats: [Q tile, unless QREG] [STAGES x (K, V) ring]
// [K lo] [V lo]; every row D + 4 floats apart.  MINB blocks fit an SM:
// ptxas keeps the registers to that (launch bounds), the assert below the
// shared memory (1 KB of each block's is the system's).
template <int D, int WARPS, int BK, int STAGES, bool QREG, int MINB>
struct Cfg {
  static constexpr int BQ = 16 * WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int P = D + 4;
  static constexpr int TILE = BK * P;
  static constexpr int Q_FLOATS = QREG ? 0 : BQ * P;
  static constexpr int SMEM = 4 * (Q_FLOATS + (2 * STAGES + 2) * TILE);
  static_assert(D % 16 == 0 && BK % 8 == 0 && STAGES >= 2, "tiles");
  static_assert(MINB * (SMEM + 1024) <= 233472, "shared memory");
};

template <int D, int WARPS, int BK, int STAGES, bool QREG, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ part, float* __restrict__ lse, int h,
           int hkv, int sq, int skv, int causal, int has_window,
           long long window, long long q_offset, float scale2, int splits) {
  using C = Cfg<D, WARPS, BK, STAGES, QREG, MINB>;
  constexpr int BQ = C::BQ, P = C::P, NT = BK / 8, DT = D / 8;
  constexpr int QK = QREG ? DT : 1;
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const ring = q_s + C::Q_FLOATS;
  float* const k_lo = ring + 2 * STAGES * C::TILE;
  float* const v_lo = k_lo + C::TILE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qtiles = (sq + BQ - 1) / BQ;
  const int heads = gridDim.x / (qtiles * splits);  // B * H
  const int y = blockIdx.x / heads;
  const int qt = qtiles - 1 - y / splits;
  const int split_id = y % splits;
  const int bh = blockIdx.x % heads;
  const int bkv = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int q0 = qt * BQ;
  const long long row0 = static_cast<long long>(bh) * sq;
  const float* const kb = k + static_cast<long long>(bkv) * skv * D;
  const float* const vb = v + static_cast<long long>(bkv) * skv * D;

  // The keys [kv_lo, kv_hi) are the only ones the masks can keep for this
  // q tile; this block takes its split's share of those KV tiles.
  const int rows = min(BQ, sq - q0);
  const long long q_lo = q_offset + q0, q_hi = q_lo + rows - 1;
  long long kv_lo = 0, kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, q_hi + 1);
  if (has_window) kv_lo = max(kv_lo, q_lo - window + 1);
  int t_first = 0, n_tiles = 0;
  if (kv_lo < kv_hi) {
    t_first = static_cast<int>(kv_lo / BK);
    n_tiles = static_cast<int>((kv_hi - 1) / BK) - t_first + 1;
  }
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = t_first + min(n_tiles, split_id * per);
  const int nt = t_first + min(n_tiles, (split_id + 1) * per) - t_begin;

  // This warp's rows: wr .. wr + 15 (those past Sq are not stored).
  const int wr = q0 + 16 * warp;
  const bool live = wr < sq;
  const long long qw_lo = q_offset + wr;
  const long long qw_hi = q_offset + min(wr + 15, sq - 1);

  // Q, scaled by sm_scale * log2 e: split A fragments in registers, or the
  // scaled tile in shared memory.
  uint32_t qh[QK][4], ql[QK][4];
  if constexpr (QREG) {
    auto at = [&](int r, int c) {
      return r < sq ? q[(row0 + r) * D + c] * scale2 : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const int c = 8 * kk + t;
      split_tf32(at(wr + g, c), qh[kk][0], ql[kk][0]);
      split_tf32(at(wr + g + 8, c), qh[kk][1], ql[kk][1]);
      split_tf32(at(wr + g, c + 4), qh[kk][2], ql[kk][2]);
      split_tf32(at(wr + g + 8, c + 4), qh[kk][3], ql[kk][3]);
    }
  } else {
    for (int i = tid; i < BQ * D / 4; i += C::THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq)
        x = *reinterpret_cast<const float4*>(q + (row0 + q0 + r) * D + c);
      *reinterpret_cast<float4*>(q_s + r * P + c) = make_float4(
          x.x * scale2, x.y * scale2, x.z * scale2, x.w * scale2);
    }
  }

  auto load = [&](int st, int tile) {
    const long long k0 = static_cast<long long>(tile) * BK;
    float* const ks = ring + 2 * st * C::TILE;
    for (int i = tid; i < BK * D / 4; i += C::THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = k0 + r < skv;
      const long long gi = ok ? (k0 + r) * D + c : 0;
      cp_async16(ks + r * P + c, kb + gi, ok);
      cp_async16(ks + C::TILE + r * P + c, vb + gi, ok);
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load(st, t_begin + st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < nt; ++it) {
    // Tile it has landed, and every warp is done with tile it - 1's slot
    // and the lo tiles.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < nt) load(nxt % STAGES, t_begin + nxt);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // Split the tile once for the block: hi in place, lo beside it.
    float* const ks = ring + 2 * (it % STAGES) * C::TILE;
    float* const vs = ks + C::TILE;
    for (int i = tid; i < BK * D / 4; i += C::THREADS) {
      const int off = (i / (D / 4)) * P + (i % (D / 4)) * 4;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        float* const x = (which ? vs : ks) + off;
        float* const lo = (which ? v_lo : k_lo) + off;
        const float4 a = *reinterpret_cast<const float4*>(x);
        const float4 hi = make_float4(tf32(a.x), tf32(a.y), tf32(a.z),
                                      tf32(a.w));
        *reinterpret_cast<float4*>(x) = hi;
        *reinterpret_cast<float4*>(lo) =
            make_float4(tf32(a.x - hi.x), tf32(a.y - hi.y),
                        tf32(a.z - hi.z), tf32(a.w - hi.w));
      }
    }
    __syncthreads();

    const long long k0 = static_cast<long long>(t_begin + it) * BK;
    if (!live || (causal && k0 > qw_hi) ||
        (has_window && qw_lo - (k0 + BK - 1) >= window))
      continue;                         // no row of this warp keeps a key
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > qw_lo) ||
                      (has_window && qw_hi - k0 >= window);

    // S (16 rows x BK keys) = Q K^T; s[j]: keys 8 j .. 8 j + 7.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const float* const qr = q_s + (16 * warp + g) * P + 8 * kk + t;
        split_tf32(qr[0], ah[0], al[0]);
        split_tf32(qr[8 * P], ah[1], al[1]);
        split_tf32(qr[4], ah[2], al[2]);
        split_tf32(qr[8 * P + 4], ah[3], al[3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int off = (8 * j + g) * P + 8 * kk + t;
        mma3(s[j], ah, al, u32(ks[off]), u32(ks[off + 4]), u32(k_lo[off]),
             u32(k_lo[off + 4]));
      }
    }

    // Masks (edge tiles only), then the online softmax in base 2.
    // s[j][e]: row g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2.
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kept(qw_lo + g + 8 * (e / 2), k0 + 8 * j + 2 * t + e % 2, skv,
                    causal, has_window, window))
            s[j][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
      base[hf] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m[hf] - base[hf]);    // 0 while m is -inf
      m[hf] = m_new;
      l[hf] *= alpha;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }

    // acc += P V, P from registers: A column t is key 2 t, t + 4 is 2 t + 1.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[j][e] - base[e / 2]);
        l[e / 2] += p[e];
      }
      uint32_t ph[4], pl[4];
      split_tf32(p[0], ph[0], pl[0]);        // row g,     key 2 t
      split_tf32(p[2], ph[1], pl[1]);        // row g + 8, key 2 t
      split_tf32(p[1], ph[2], pl[2]);        // row g,     key 2 t + 1
      split_tf32(p[3], ph[3], pl[3]);        // row g + 8, key 2 t + 1
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int off = (8 * j + 2 * t) * P + 8 * n + g;
        mma3(acc[n], ph, pl, u32(vs[off]), u32(vs[off + P]), u32(v_lo[off]),
             u32(v_lo[off + P]));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (!live) return;

  // Epilogue: o = acc / l (0 for a row that kept no key), or the partial.
  const long long rows_all = static_cast<long long>(heads) * sq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    const int r = wr + g + 8 * hf;
    if (r >= sq) continue;
    const long long row = row0 + r;
    if (splits == 1) {
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
      float* const out = o + row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc[n][2 * hf] * inv, acc[n][2 * hf + 1] * inv);
      if (lse != nullptr && t == 0) lse[row] = lse_of(m[hf], l[hf]);
    } else {
      const long long prow = split_id * rows_all + row;
      float* const pacc = part + prow * D + 2 * t;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        *reinterpret_cast<float2*>(pacc + 8 * n) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(part + splits * rows_all * D + prow * 2) =
            make_float2(m[hf], l[hf]);
    }
  }
}

// Merges the splits' partials: one thread per 4 columns of an output row,
// COMBINE_THREADS a block.  A split whose row kept no key has m = -inf,
// l = 0 and weighs 0; a row with no key in any split stores 0 (and lse
// -inf).  The row's first thread writes its lse where lse is not null.
constexpr int COMBINE_THREADS = 256;

__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part, float* __restrict__ o,
               float* __restrict__ lse, int splits, long long rows, int d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * COMBINE_THREADS + threadIdx.x;
  if (i >= rows * (d / 4)) return;
  const long long row = i / (d / 4);
  const int c = static_cast<int>(i % (d / 4)) * 4;
  const float* const ml = part + splits * rows * d;
  float mm = -INFINITY;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, ml[(s * rows + row) * 2]);
  float ll = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mm != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const long long sr = s * rows + row;
      const float ms = ml[sr * 2];
      if (ms == -INFINITY) continue;
      const float wt = exp2f(ms - mm);
      const float4 x = *reinterpret_cast<const float4*>(part + sr * d + c);
      ll += wt * ml[sr * 2 + 1];
      a = make_float4(a.x + wt * x.x, a.y + wt * x.y, a.z + wt * x.z,
                      a.w + wt * x.w);
    }
  }
  const float inv = ll > 0.f ? 1.f / ll : 0.f;
  *reinterpret_cast<float4*>(o + row * d + c) =
      make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  if (lse != nullptr && c == 0) lse[row] = lse_of(mm, ll);
}

// The launch geometry that flash_attention.plan chose (field order as
// AttentionPlan.c_plan in kernels/flash_attention.py; path 0 is f32).  The
// library launches a plan only when it has an instantiation with exactly
// that geometry, so the plan and the kernels cannot drift apart unnoticed.
struct Plan {
  int path, block_q, block_kv, stages, splits, chunk, smem, gx, gy, gz;
};

struct Args {
  const float *q, *k, *v;
  float *o, *part, *lse;
  int b, h, hkv, sq, skv, causal, has_window;
  long long window, q_offset;
  float scale2;
  Plan p;
  int* launched;     // kernels launched so far
  cudaStream_t stream;
};

template <int D, int WARPS, int BK, int STAGES, bool QREG, int MINB>
cudaError_t launch(const Args& a) {
  using C = Cfg<D, WARPS, BK, STAGES, QREG, MINB>;
  const long long blocks = static_cast<long long>((a.sq + C::BQ - 1) / C::BQ) *
                           a.p.splits * a.h * a.b;
  if (a.p.path != 0 || a.p.smem != C::SMEM || a.p.splits <= 0 ||
      a.p.chunk != 0 || blocks >= (1LL << 31) || a.p.gx != blocks ||
      a.p.gy != 1 || a.p.gz != 1 || (a.p.splits > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  auto kernel = f32_kernel<D, WARPS, BK, STAGES, QREG, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, a.stream>>>(
      a.q, a.k, a.v, a.o, a.part, a.lse, a.h, a.hkv, a.sq, a.skv, a.causal,
      a.has_window, a.window, a.q_offset, a.scale2, a.p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*a.launched;
  if (a.p.splits == 1) return err;
  const long long rows = static_cast<long long>(a.b) * a.h * a.sq;
  const long long threads = rows * (D / 4);
  combine_kernel<<<static_cast<unsigned>((threads + COMBINE_THREADS - 1) /
                                         COMBINE_THREADS),
                   COMBINE_THREADS, 0, a.stream>>>(a.part, a.o, a.lse,
                                                   a.p.splits, rows, D);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*a.launched;
  return err;
}

// The instantiations: (D, warps, keys a tile, stages, Q fragments in
// registers, blocks an SM).  A plan names one by its head dim, block_q (16
// rows a warp), block_kv and stages; its shared memory must match too.
cudaError_t dispatch(const Args& a, int d) {
  const Plan& p = a.p;
#define FA_CASE(D, W, BK, ST, QREG, MINB)                                   \
  if (d == D && p.block_q == 16 * W && p.block_kv == BK && p.stages == ST)  \
    return launch<D, W, BK, ST, QREG, MINB>(a);
  FA_CASE(16, 4, 64, 2, true, 2)
  FA_CASE(32, 4, 64, 2, true, 2)
  FA_CASE(64, 8, 64, 2, true, 1)
  FA_CASE(128, 4, 32, 2, false, 1)
  FA_CASE(192, 4, 16, 2, false, 1)
  FA_CASE(256, 4, 16, 2, false, 1)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches the plan's kernels on `stream`: the attention kernel, followed
// by the combine kernel where the keys are split (`scratch` then holds the
// float32 partials); `lse`, where not null, gets each row's float32
// log-sum-exp.  *launched counts the kernels this call launched (0 to 2).
// Returns a cudaError_t, 0 on success.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* scratch,
    void* lse, int b, int h, int hkv, int sq, int skv, int d, int causal, int has_window,
    long long window, long long q_offset, float sm_scale, const void* plan,
    int* launched, void* stream) {
  *launched = 0;
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv < 0 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o),
               static_cast<float*>(scratch), static_cast<float*>(lse), b, h,
               hkv, sq, skv, causal, has_window, window, q_offset,
               sm_scale * LOG2E,
               *static_cast<const Plan*>(plan), launched,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, d));
}
