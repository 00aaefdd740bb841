// flash_attention_bf16.cu - bf16 attention for Hopper (sm_90a) on the tensor
// cores: wgmma for prefill, a split-KV GQA-packed path for decode.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:34
// (_flash_kernel, called by flash_attention at :88) for bfloat16 inputs; the
// float32 inputs stay on csrc/flash_attention.cu.  It computes
//
//   o[b, h, i] = sum_j softmax_j(s[i, j]) v[b, h / group, j],
//   s[i, j]    = sm_scale * q[b, h, i] . k[b, h / group, j]
//
// over the keys j that the masks keep (j < Skv; q_pos >= k_pos when causal;
// q_pos - k_pos < window), with q_pos = q_offset + i, k_pos = j, and o = 0
// for a row that keeps no key.  q (B, H, Sq, D), k and v (B, Hkv, Skv, D),
// o (B, H, Sq, D): row-major, contiguous, bf16, 16-byte aligned; H % Hkv ==
// 0; D in {16, 32, 64, 128, 192, 256}.
//
// Precision.  Q K^T multiplies bf16 inputs exactly and sums in float32;
// sm_scale (times log2 e, for exp2) is applied to S in float32.  The running
// max m, sum l and accumulator are float32 and o is rounded once.  P is kept
// at about 16 bits for P V: hi is p truncated to bf16, lo = bf16(p - hi)
// rounded to nearest, and P V = hi V + lo V, two bf16 products accumulated
// in float32 (V is exact in bf16), so hi + lo holds p to 2^-16 relative.
// Rounding P to bf16 alone, as most tensor-core kernels do, changes about
// 40 % of the bf16 outputs against the float32 softmax of the plain version
// (ref.attention_ref); hi + lo changes under 1 %.  The split costs 6 D
// tensor-core operations per kept pair against the algorithm's 4 D.
//
// What bounds each path on an H100, and what the design does about it.
//
//  * bf16_tiles (prefill, chunked prefill, long Sq): hundreds to thousands
//    of operations per byte, so bound by the tensor cores (989 TFLOP/s).
//    One block of two consumer warpgroups owns 128 q rows of one head (64
//    each).  S = Q K^T runs on wgmma.mma_async m64nBKk16 with Q and K in
//    shared memory; P V runs on wgmma with P in registers, converted in place
//    from the S accumulator fragment (the two fragments coincide), and V in
//    shared memory as the MN-major B operand (transpose-B bit set).  K and V
//    tiles arrive by TMA (cp.async.bulk.tensor, completion on an mbarrier)
//    into a ring of three stages (two at D = 256, for shared memory): the
//    second warpgroup to finish with a stage requests the tile that goes
//    there next, so copies run while earlier tiles are multiplied.  The
//    warpgroups take turns to issue their products (named barriers).  The
//    swizzle follows the row bytes of D (32 B at D = 16, 64 B at D = 32,
//    128 B from D = 64); at 128 B a row of D = 128, 192 or 256 loads as 2,
//    3 or 4 boxes of 64, and P V runs in N parts that each start on a box
//    (one of D up to 128, three of 64 at D = 192, two of 128 at D = 256).  One conversion per pair of scores (hi is a byte
//    permute) and ex2 with the scale folded into one FFMA keep the
//    softmax, which shares the SM with the products, short.
//    The causal and window bounds choose the first and last KV tile; only
//    edge tiles apply per-score masks.  TMA zero-fills rows past Sq and Skv,
//    and keys >= Skv are still masked per score (a zero key scores 0 and
//    would join the softmax).  Blocks take the heaviest causal q tiles first.
//    When the q-tile grid fills at most half of the card's SMs (chunked
//    prefill), each block also takes one of `splits` parts of its KV range
//    and writes float32 partials that the combine kernel merges.
//  * bf16_split (decode: group * Sq <= 16 packed rows): reads all of K and V
//    for a handful of rows, so bound by bytes (3.35 TB/s).  The grid is
//    (splits, Hkv, B): a block stacks the group * Sq query rows of one KV
//    head into one 16-row tile and streams its KV chunk once for all of
//    them, through a 3-stage (2 at D = 256) ring of 16-byte cp.async copies.
//    Products are mma.sync m16n8k16 (16 rows are all there is; wgmma would
//    pad them to 64), each of the 4 warps taking 16 keys of each 64-key tile;
//    the warps merge in shared memory and the block writes its partial
//    (m, l, acc[D]) in float32.  The split count gives about two waves.
//  * combine: one block per output row merges the splits' partials with the
//    same max rescale.  A split whose row kept no key has m = -inf, l = 0 and
//    weighs 0; a row with no key in any split stores 0.
//
// lse (optional, float32 (B, H, Sq)): the row's log-sum-exp of the scaled
// scores, ln sum_j exp(s[i, j]) over the kept keys, -inf for a row that
// keeps no key (whose o is 0), for a sequence-sharded decode's combine
// across ranks (serving/engine.py).  The combine kernel writes it after a
// split, the tiles kernel's epilogue where the keys are not split, both
// from (m, l) through lse_of: no extra launch.  With lse, o is float32,
// not rounded to bf16: the combine across ranks weighs and sums the
// ranks' o, and a bf16 o rounded there and again after the sum would
// move about a third of the outputs by one bf16 ulp.
//
// Partials: acc at scratch[(split * rows + row) * D + c], then (m, l) pairs
// at scratch[splits * rows * D + (split * rows + row) * 2]; rows = B*H*Sq
// and row = (b * H + h) * Sq + i.  m is in base-2 units: the largest kept
// s * log2(e), -inf where none is kept; l = sum 2^(s log2 e - m).
//
// Interface: one plain C function, loaded with ctypes.  It takes the path,
// tiles, stages, splits, shared memory and grid that kernels/
// flash_attention.py's plan chose, and refuses a plan it has no
// instantiation for.  It launches on the caller's stream (one or two
// kernels), does not synchronise, allocates nothing, reports the kernels it
// launched, and returns a cudaError_t (0 on success); a null lse pointer
// writes no lse; tensor maps are
// encoded on the host through cudaGetDriverEntryPoint, with no link to
// libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A row's log-sum-exp from its base-2 running max m (the largest kept
// s * log2 e) and sum l = sum 2^(s log2 e - m): ln(2^m l); -inf where the
// row kept no key (l == 0).
__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * LN2 : -INFINITY;
}

// -- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the barrier's phase with `parity` to complete.  A completion
// that never comes (a refused copy) traps after about 2^28 polls, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 28)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is reported to `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Named barriers 1..4 (0 is __syncthreads): bar.sync waits for `n` threads,
// bar.arrive counts this warp in and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instruction's issue or wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode of the tile.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p as two bf16 parts, for a pair: hi keeps the top 16 bits of p (bf16 by
// truncation, a byte permute), lo = bf16(p - hi) rounded to nearest, so
// hi + lo holds p to 2^-16 relative with one conversion per pair.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xh = __float_as_uint(x) & 0xFFFF0000u;
  const uint32_t yh = __float_as_uint(y) & 0xFFFF0000u;
  hi = __byte_perm(xh, yh, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xh), y - __uint_as_float(yh));
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

// Whether key kp is kept for a query at position qp.
__device__ __forceinline__ bool kept(long long qp, long long kp, int skv,
                                     int causal, int has_window,
                                     long long window) {
  return kp < skv && (!causal || qp >= kp) &&
         (!has_window || qp - kp < window);
}

// -- wgmma: one m64nNk16 product a call (asm operands written out) ------------

// S = Q K^T: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- bf16_tiles: wgmma prefill ---------------------------------------------

template <int D, int BK>
struct TileCfg {
  static constexpr int BQ = 128;                 // q rows: 2 warpgroups x 64
  static constexpr int THREADS = 256;
  static constexpr int STAGES = D <= 192 ? 3 : 2;   // K/V ring
  static constexpr int SW = D >= 64 ? 128 : 2 * D;   // swizzle = row bytes
  static constexpr int E = SW / 2;               // bf16 per box row
  static constexpr int BOXES = D / E;            // boxes per row of D
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or one V tile
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES;
  // P V in N <= 128 parts, each a whole number of boxes
  static constexpr int HALVES = D == 192 ? 3 : D > 128 ? 2 : 1;
  static constexpr int ON = D / HALVES;
  static_assert(ON % E == 0 && ON <= 128, "P V parts");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int D, int BK>
__global__ void __launch_bounds__(256, 1)
tiles_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
             float* __restrict__ part, float* __restrict__ lse, int h,
             int hkv, int sq, int skv,
             int causal, int has_window, long long window, long long q_offset,
             float scale2, int splits) {
  using C = TileCfg<D, BK>;
  constexpr int BQ = C::BQ, SW = C::SW, E = C::E;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[C::STAGES];
  __shared__ int consumed[C::STAGES];    // warpgroups done with a stage
  // 128-byte swizzled tiles must start on a 1024-byte boundary.
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  auto k_s = [&](int st) { return smem + C::Q_BYTES + st * 2 * C::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + C::KV_BYTES; };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // One-dimensional grid, every (batch, head) of a q tile together and the
  // q tiles heaviest first (causal), so the last wave holds the light ones.
  const int qtiles = (sq + BQ - 1) / BQ;
  const int heads = gridDim.x / (qtiles * splits);  // B * H
  const int y = blockIdx.x / heads;
  const int qt = qtiles - 1 - y / splits;
  const int split = y % splits;
  const int bh = blockIdx.x % heads;
  const int bkv = (bh / h) * hkv + (bh % h) / (h / hkv);
  const int q0 = qt * BQ;

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
  const int t_begin = t_first + min(n_tiles, split * per);
  const int nt = t_first + min(n_tiles, (split + 1) * per) - t_begin;

  auto load_kv = [&](int st, int t) {
    mbar_expect_tx(&bar_kv[st], 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c) {
      tma_load(k_s(st) + c * BK * SW, &tk, &bar_kv[st], c * E, t * BK, bkv);
      tma_load(v_s(st) + c * BK * SW, &tv, &bar_kv[st], c * E, t * BK, bkv);
    }
  };
  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&bar_kv[st], 1);
      consumed[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::BOXES; ++c)
      tma_load(q_s + c * BQ * SW, &tq, &bar_q, c * E, q0, bh);
    for (int st = 0; st < C::STAGES && st < nt; ++st) load_kv(st, t_begin + st);
  }

  // Thread fragment: rows r0 and r0 + 8 of the block's tile; accumulator
  // element i sits in row half (i / 2) % 2, column 8 (i / 4) + 2 (lane % 4)
  // + i % 2 (the wgmma m64nN f32 layout).
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const long long qp[2] = {q_lo + r0, q_lo + r0 + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[C::HALVES][C::ON / 2];
#pragma unroll
  for (int hh = 0; hh < C::HALVES; ++hh)
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) acc[hh][i] = 0.f;

  // Descriptors.  Q and K are K-major (D contiguous): rows 8 x SW bytes per
  // swizzle atom, a 16-wide k step moves 32 bytes inside a box row or to the
  // next box.  V is MN-major (D contiguous, keys down): the next E columns
  // are a box away (LBO), the next 8 keys 8 x SW bytes (SBO).
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * SW;
  auto q_desc = [&](int kk) {
    const int e = 16 * kk;
    return make_desc<SW>(q_addr + (e / E) * BQ * SW + (e % E) * 2, 16,
                         8 * SW);
  };

  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2: a warpgroup waits on its own, then lets the other go), so
  // one's softmax runs while the other's wgmma holds the tensor cores.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) named_arrive(1, 256);    // warpgroup 0 goes first
  mbar_wait(&bar_q, 0);
  for (int it = 0; it < nt; ++it) {
    const int st = it % C::STAGES;
    const int k0 = (t_begin + it) * BK;
    mbar_wait(&bar_kv[st], (it / C::STAGES) & 1);

    float s[BK / 2];
    const uint32_t k_addr = smem_u32(k_s(st));
    reg_fence(s);
    wg_fence();
    named_sync(my_turn, 256);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int e = 16 * kk;
      wgmma_ss(s, q_desc(kk),
               make_desc<SW>(k_addr + (e / E) * BK * SW + (e % E) * 2, 16,
                             8 * SW),
               kk > 0);
    }
    wg_commit();
    named_arrive(their_turn, 256);
    wg_wait_all();
    reg_fence(s);

    // Scale and mask (edge tiles only), then the online softmax update.
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q_lo) ||
                      (has_window && k0 <= q_hi - window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        if (!kept(qp[(i / 2) % 2], kp, skv, causal, has_window, window))
          s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // scores are scaled inside the exponent (scale2 > 0 keeps the max)
      const float m_new = fmaxf(m[hf], quad_max(mx[hf]) * scale2);
      base[hf] = m_new == -INFINITY ? 0.f : m_new;   // row kept nothing yet
      const float alpha = ex2(m[hf] - base[hf]);     // 0 while m is -inf
      m[hf] = m_new;
      l[hf] *= alpha;
#pragma unroll
      for (int hh = 0; hh < C::HALVES; ++hh)
#pragma unroll
        for (int i = 0; i < C::ON / 2; ++i)
          if ((i / 2) % 2 == hf) acc[hh][i] *= alpha;
    }
    // P in place as the A fragment of m64nDk16: k step kk holds S columns
    // 16 kk .. 16 kk + 15, which are s[8 kk .. 8 kk + 7].
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float p0 = ex2(fmaf(s[i], scale2, -base[(i / 2) % 2]));
      const float p1 = ex2(fmaf(s[i + 1], scale2, -base[(i / 2) % 2]));
      l[(i / 2) % 2] += p0 + p1;
      split_pair(p0, p1, p_hi[i / 8][(i % 8) / 2], p_lo[i / 8][(i % 8) / 2]);
    }

    const uint32_t v_addr = smem_u32(v_s(st));
#pragma unroll
    for (int hh = 0; hh < C::HALVES; ++hh) reg_fence(acc[hh]);
    wg_fence();
    named_sync(my_turn, 256);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < C::HALVES; ++hh) {
        const uint64_t vd = make_desc<SW>(
            v_addr + hh * (C::ON / E) * BK * SW + kk * 16 * SW, BK * SW,
            8 * SW);
        wgmma_rs(acc[hh], p_hi[kk], vd);
        wgmma_rs(acc[hh], p_lo[kk], vd);
      }
    wg_commit();
    named_arrive(their_turn, 256);
    wg_wait_all();
#pragma unroll
    for (int hh = 0; hh < C::HALVES; ++hh) reg_fence(acc[hh]);

    // The second warpgroup to finish with stage st refills it.
    named_sync(3 + wg, 128);
    if (tid % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&consumed[st], 1) == 1) {
        consumed[st] = 0;
        if (it + C::STAGES < nt) load_kv(st, t_begin + it + C::STAGES);
      }
    }
  }
  if (wg == 0) named_sync(1, 256);      // the last turn warpgroup 1 gave

  // Epilogue: o = acc / l (0 for a row that kept no key), or the partial.
  const long long rows_all = static_cast<long long>(heads) * sq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    const int r = r0 + 8 * hf;
    if (q0 + r >= sq) continue;
    const long long row = static_cast<long long>(bh) * sq + q0 + r;
    if (splits == 1) {
      const float inv = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
#pragma unroll
      for (int hh = 0; hh < C::HALVES; ++hh)
#pragma unroll
        for (int i = 0; i < C::ON / 2; i += 2) {
          if ((i / 2) % 2 != hf) continue;
          const int c = hh * C::ON + 8 * (i / 4) + 2 * (lane % 4);
          const float x0 = acc[hh][i] * inv, x1 = acc[hh][i + 1] * inv;
          if (o32 != nullptr)
            *reinterpret_cast<float2*>(o32 + row * D + c) =
                make_float2(x0, x1);
          else
            *reinterpret_cast<__nv_bfloat162*>(o + row * D + c) =
                __floats2bfloat162_rn(x0, x1);
        }
      if (lse != nullptr && lane % 4 == 0) lse[row] = lse_of(m[hf], l[hf]);
    } else {
      const long long prow = split * rows_all + row;
      float* pacc = part + prow * D;
#pragma unroll
      for (int hh = 0; hh < C::HALVES; ++hh)
#pragma unroll
        for (int i = 0; i < C::ON / 2; i += 2) {
          if ((i / 2) % 2 != hf) continue;
          const int c = hh * C::ON + 8 * (i / 4) + 2 * (lane % 4);
          *reinterpret_cast<float2*>(pacc + c) =
              make_float2(acc[hh][i], acc[hh][i + 1]);
        }
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(part + splits * rows_all * D + prow * 2) =
            make_float2(m[hf], l[hf]);
    }
  }
}

// -- bf16_split: GQA-packed split-KV decode ----------------------------------

constexpr int SPLIT_ROWS = 16;      // packed rows: one m16 tile
constexpr int SPLIT_TILE = 64;      // keys per stage; 16 per warp
constexpr int SPLIT_THREADS = 128;

template <int D>
struct SplitCfg {
  static constexpr int STAGES = D <= 192 ? 3 : 2;
  static constexpr int PITCH = D + 8;            // bf16; ldmatrix rows in
                                                 // distinct banks
  static constexpr int TILE_BYTES = SPLIT_TILE * PITCH * 2;
  static constexpr int SMEM = STAGES * 2 * TILE_BYTES;
  static_assert(SMEM >= 4 * SPLIT_ROWS * D * 4, "merge buffer");
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, float* __restrict__ part,
             int h, int hkv, int sq, int skv, int causal, int has_window,
             long long window, long long q_offset, float scale2, int chunk) {
  using C = SplitCfg<D>;
  constexpr int P = C::PITCH;
  extern __shared__ uint4 smem4[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  auto k_s = [&](int st) { return kv_s + st * 2 * SPLIT_TILE * P; };
  auto v_s = [&](int st) { return k_s(st) + SPLIT_TILE * P; };
  __shared__ float m_s[4][SPLIT_ROWS], l_s[4][SPLIT_ROWS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, splits = gridDim.x;
  const int group = h / hkv;
  const int packed = group * sq;                     // <= SPLIT_ROWS
  const long long rows_all = static_cast<long long>(gridDim.z) * h * sq;
  // The group's query heads are consecutive, so its packed rows are the
  // global rows row0 .. row0 + packed - 1.
  const long long row0 =
      (static_cast<long long>(blockIdx.z) * h + blockIdx.y * group) * sq;
  const long long kv_base =
      (static_cast<long long>(blockIdx.z) * hkv + blockIdx.y) * skv * D;

  // This split's keys [lo, hi), cut to what the masks can keep.
  long long lo = static_cast<long long>(split) * chunk;
  long long hi = min(static_cast<long long>(skv), lo + chunk);
  if (causal) hi = min(hi, q_offset + sq);
  if (has_window) lo = max(lo, q_offset - window + 1);
  const long long t0 = (lo / SPLIT_TILE) * SPLIT_TILE;
  const int nt = lo < hi ? static_cast<int>((hi - t0 + SPLIT_TILE - 1) /
                                            SPLIT_TILE)
                         : 0;

  auto load = [&](int st, int t) {
    const long long k0 = t0 + static_cast<long long>(t) * SPLIT_TILE;
    constexpr int PER_ROW = D / 8;                  // 16-byte pieces per row
    for (int i = tid; i < SPLIT_TILE * PER_ROW; i += SPLIT_THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
      const bool ok = k0 + r < skv;
      const long long g = kv_base + (ok ? (k0 + r) * D + c : 0);
      cp_async16(k_s(st) + r * P + c, k + g, ok);
      cp_async16(v_s(st) + r * P + c, v + g, ok);
    }
  };

  // Q as the A fragments of m16n8k16, one per 16-wide k step; rows past the
  // packed count are zero.
  uint32_t qa[D / 16][4];
  {
    const int ra = lane / 4, rb = ra + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * (lane % 4);
      auto at = [&](int r, int cc) -> uint32_t {
        return r < packed ? *reinterpret_cast<const uint32_t*>(
                                q + (row0 + r) * D + cc)
                          : 0u;
      };
      qa[kk][0] = at(ra, c);
      qa[kk][1] = at(rb, c);
      qa[kk][2] = at(ra, c + 8);
      qa[kk][3] = at(rb, c + 8);
    }
  }
  const long long qp[2] = {q_offset + (lane / 4) % sq,
                           q_offset + (lane / 4 + 8) % sq};
  const bool live[2] = {lane / 4 < packed, lane / 4 + 8 < packed};

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nt) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < nt; ++it) {
    const int nxt = it + C::STAGES - 1;
    if (nxt < nt) load(nxt % C::STAGES, nxt);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(C::STAGES - 1) : "memory");
    __syncthreads();

    const int st = it % C::STAGES;
    const long long kw = t0 + static_cast<long long>(it) * SPLIT_TILE +
                         16 * warp;                 // this warp's 16 keys
    // S (16 rows x 16 keys) = Q K^T
    float s[2][4] = {};
    const __nv_bfloat16* kb = k_s(st) + (16 * warp) * P;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, kb + ((lane / 16) * 8 + lane % 8) * P + 16 * kk +
                         ((lane / 8) % 2) * 8,
                  false);
      mma16816(s[0], qa[kk], b[0], b[1]);
      mma16816(s[1], qa[kk], b[2], b[3]);
    }
    // c[j][e]: row lane / 4 + 8 (e / 2), key kw + 8 j + 2 (lane % 4) + e % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long kp = kw + 8 * j + 2 * (lane % 4) + e % 2;
        float x = s[j][e] * scale2;
        if (!live[e / 2] ||
            !kept(qp[e / 2], kp, skv, causal, has_window, window))
          x = -INFINITY;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
      base[hf] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[hf] - base[hf]);
      m[hf] = m_new;
      l[hf] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * hf] *= alpha;
        acc[j][2 * hf + 1] *= alpha;
      }
    }
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float p0 = exp2f(s[j][2 * hf] - base[hf]);
        const float p1 = exp2f(s[j][2 * hf + 1] - base[hf]);
        l[hf] += p0 + p1;
        split_pair(p0, p1, ph[2 * j + hf], pl[2 * j + hf]);
      }
    // acc += P V over this warp's 16 keys; V^T fragments by ldmatrix.trans
    const __nv_bfloat16* vb = v_s(st) + (16 * warp) * P;
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, vb + (((lane / 8) % 2) * 8 + lane % 8) * P +
                         8 * (j + lane / 16),
                  true);
      mma16816(acc[j], ph, b[0], b[1]);
      mma16816(acc[j], pl, b[0], b[1]);
      mma16816(acc[j + 1], ph, b[2], b[3]);
      mma16816(acc[j + 1], pl, b[2], b[3]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // Merge the four warps' (m, l, acc) in shared memory; write the partial.
  float* acc_s = reinterpret_cast<float*>(smem4);    // [4][16][D]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    const int r = lane / 4 + 8 * hf;
    if (lane % 4 == 0) {
      m_s[warp][r] = m[hf];
      l_s[warp][r] = l[hf];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(
          &acc_s[(warp * SPLIT_ROWS + r) * D + 8 * j + 2 * (lane % 4)]) =
          make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
  __syncthreads();
  for (int i = tid; i < packed * D; i += SPLIT_THREADS) {
    const int r = i / D, c = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, m_s[w][r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (m_s[w][r] == -INFINITY) continue;          // weighs 0
      const float wt = exp2f(m_s[w][r] - mm);
      ll += wt * l_s[w][r];
      a += wt * acc_s[(w * SPLIT_ROWS + r) * D + c];
    }
    const long long prow = split * rows_all + row0 + r;
    part[prow * D + c] = a;
    if (c == 0)
      *reinterpret_cast<float2*>(part + splits * rows_all * D + prow * 2) =
          make_float2(mm, ll);
  }
}

// -- combine: one block of D threads per output row --------------------------
// (o in float32 to o32 where it is not null; thread 0 writes the row's lse
// where lse is not null)

__global__ void combine_kernel(const float* __restrict__ part,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ o32,
                               float* __restrict__ lse, int splits,
                               long long rows, int d) {
  const long long row = blockIdx.x;
  const int c = threadIdx.x;
  const float* ml = part + splits * rows * d;
  float mm = -INFINITY;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, ml[(s * rows + row) * 2]);
  float ll = 0.f, a = 0.f;
  if (mm != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float ms = ml[(s * rows + row) * 2];
      if (ms == -INFINITY) continue;    // a split that kept no key weighs 0
      const float wt = exp2f(ms - mm);
      ll += wt * ml[(s * rows + row) * 2 + 1];
      a += wt * part[(s * rows + row) * d + c];
    }
  }
  const float x = ll > 0.f ? a / ll : 0.f;
  if (o32 != nullptr)
    o32[row * d + c] = x;
  else
    o[row * d + c] = __float2bfloat16_rn(x);
  if (lse != nullptr && c == 0) lse[row] = lse_of(mm, ll);
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, rows, D) bf16 as a 3-D tensor map with boxes of (1, box_rows,
// sw / 2): rows past `rows` of a head read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, long long heads, int rows,
              int d, int box_rows, int sw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  rows = rows > 0 ? rows : 1;        // Skv = 0: the map is never read
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sw / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch geometry that flash_attention.plan chose (field order as
// AttentionPlan.c_plan in kernels/flash_attention.py; path 1 is bf16_tiles,
// 2 bf16_split).  The library launches a plan only when it has an
// instantiation with exactly that geometry, so the plan and the kernels
// cannot drift apart unnoticed.
struct Plan {
  int path, block_q, block_kv, stages, splits, chunk, smem, gx, gy, gz;
};

bool same_grid(const Plan& p, dim3 g) {
  return p.gx == static_cast<int>(g.x) && p.gy == static_cast<int>(g.y) &&
         p.gz == static_cast<int>(g.z);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float *part, *lse;
  int b, h, hkv, sq, skv, causal, has_window;
  long long window, q_offset;
  float scale2;
  Plan p;
  int* launched;     // kernels launched so far
  cudaStream_t stream;

  // o as the kernels write it: float32 with lse, else bf16
  __nv_bfloat16* o16() const {
    return lse == nullptr ? static_cast<__nv_bfloat16*>(o) : nullptr;
  }
  float* o32() const {
    return lse == nullptr ? nullptr : static_cast<float*>(o);
  }
};

cudaError_t combine(const Args& a, int d) {
  const long long rows = static_cast<long long>(a.b) * a.h * a.sq;
  combine_kernel<<<static_cast<unsigned>(rows), d, 0, a.stream>>>(
      a.part, a.o16(), a.o32(), a.lse, a.p.splits, rows, d);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*a.launched;
  return err;
}

template <int D, int BK>
cudaError_t launch_tiles(const Args& a) {
  using C = TileCfg<D, BK>;
  const long long blocks = static_cast<long long>((a.sq + C::BQ - 1) / C::BQ) *
                           a.p.splits * a.h * a.b;
  if (a.p.path != 1 || a.p.block_q != C::BQ || a.p.block_kv != BK ||
      a.p.stages != C::STAGES || a.p.smem != C::SMEM || a.p.splits <= 0 ||
      blocks >= (1LL << 31) ||
      !same_grid(a.p, dim3(static_cast<unsigned>(blocks), 1, 1)) ||
      (a.p.splits > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, a.q, static_cast<long long>(a.b) * a.h, a.sq, D, C::BQ,
                C::SW) ||
      !make_map(&tk, a.k, static_cast<long long>(a.b) * a.hkv, a.skv, D, BK,
                C::SW) ||
      !make_map(&tv, a.v, static_cast<long long>(a.b) * a.hkv, a.skv, D, BK,
                C::SW))
    return cudaErrorInvalidValue;
  auto kernel = tiles_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, a.o16(), a.o32(), a.part, a.lse, a.h, a.hkv, a.sq, a.skv,
      a.causal, a.has_window, a.window, a.q_offset, a.scale2, a.p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*a.launched;
  return a.p.splits == 1 ? err : combine(a, D);
}

template <int D>
cudaError_t launch_split(const Args& a) {
  using C = SplitCfg<D>;
  const dim3 grid(a.p.splits, a.hkv, a.b);
  if (a.p.path != 2 || a.p.block_q != SPLIT_ROWS ||
      a.p.block_kv != SPLIT_TILE || a.p.stages != C::STAGES ||
      a.p.smem != C::SMEM || a.p.splits <= 0 || !same_grid(a.p, grid) ||
      (a.h / a.hkv) * a.sq > SPLIT_ROWS || a.p.chunk <= 0 ||
      a.p.chunk % SPLIT_TILE != 0 || a.part == nullptr)
    return cudaErrorInvalidValue;
  auto kernel = split_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SPLIT_THREADS, C::SMEM, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.part, a.h, a.hkv, a.sq,
      a.skv, a.causal, a.has_window, a.window, a.q_offset, a.scale2,
      a.p.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*a.launched;
  return combine(a, D);
}

// The KV tile of the tiles path: 128 keys, 64 at D = 192 and 256 (registers
// and shared memory: 128 keys in three stages would need 288 KB of ring at
// D = 192).
cudaError_t dispatch(const Args& a, int d) {
  const bool split = a.p.path == 2;
  switch (d) {
    case 16: return split ? launch_split<16>(a) : launch_tiles<16, 128>(a);
    case 32: return split ? launch_split<32>(a) : launch_tiles<32, 128>(a);
    case 64: return split ? launch_split<64>(a) : launch_tiles<64, 128>(a);
    case 128: return split ? launch_split<128>(a) : launch_tiles<128, 128>(a);
    case 192: return split ? launch_split<192>(a) : launch_tiles<192, 64>(a);
    case 256: return split ? launch_split<256>(a) : launch_tiles<256, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the plan's kernels on `stream`: the tiles kernel, or the split
// kernel, each followed by the combine kernel where the keys are split;
// `scratch` holds the float32 partials; `lse`, where not null, gets each
// row's float32 log-sum-exp, and `o` is then float32.  *launched counts the
// kernels this call launched (0 to 2).  Returns a cudaError_t, 0 on
// success.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, void* scratch,
    void* lse, int b, int h, int hkv, int sq, int skv, int d, int causal, int has_window,
    long long window, long long q_offset, float sm_scale, const void* plan,
    int* launched, void* stream) {
  *launched = 0;
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 || skv < 0 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(scratch),
               static_cast<float*>(lse), b, h, hkv, sq, skv, causal,
               has_window, window, q_offset, sm_scale * LOG2E,
               *static_cast<const Plan*>(plan), launched,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(a, d));
}
