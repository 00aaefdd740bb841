// vta_gemm.cu - the VTA datapath as one fused GEMM kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/vta_gemm.py
// (_gemm_kernel / vta_gemm).  It computes the same function, not the same
// blocks:
//
//   out = commit(shr(relu?(A @ B + bias), shift))
//
//   A     int8  (M, K), row-major, contiguous
//   B     int8  (K, N), row-major, contiguous
//   bias  int32 (N,) or null, broadcast over rows (the VTA's ACC preload)
//   out   int8 or int32 (M, N)
//
// The accumulate is int32 and wraps (the VTA's ACC semantics).  relu is a
// max with 0, shift an arithmetic right shift on int32 (0..31; the wrapper
// clamps larger shifts to 31, which gives the same sign fill).  With an
// int8 output the commit either clips to [-128, 127] (saturate) or keeps
// the low 8 bits (the VTA's truncation); with an int32 output there is no
// commit.
//
// Defined wrap.  Signed overflow is undefined in C++, so nothing here adds
// signed integers that can overflow: the products are summed by __dp4a
// (PTX dp4a.s32.s32, whose 32-bit sum wraps by definition) and the bias is
// added in uint32_t.  The int8 truncation is (int8_t)(uint8_t)(v & 0xFF).
//
// What bounds it on an H100.  At LeNet-5's shapes (at batch B the layers
// are (784B x 32 x 16), (112B x 160 x 16), (B x 400 x 128),
// (B x 128 x 96), (B x 96 x 16)) one call moves at most a few MB and does
// at most a few tens of MOPs: the memory bound is a microsecond or less
// and the int8 tensor-core bound far below that, so launch latency and the
// bytes moved bound it, not int8 throughput.  The design therefore keeps
// the kernel to one pass over the operands: every output tile is owned by
// one block that loops over K itself (nothing carries between blocks, so
// no second pass and no atomics), A and B tiles are staged through shared
// memory with coalesced byte loads that mask the ragged M, N and K edges
// (no host-side padding, no extra copies), and the whole epilogue is fused
// so each output byte is written once.  The 4-way int8 dot products run
// on the CUDA cores (__dp4a); wgmma and TMA are left for when larger
// shapes make the tensor cores the limit.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                  // output rows per block
constexpr int BN = 64;                  // output columns per block
constexpr int BK = 32;                  // K bytes staged per step
constexpr int THREADS = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr int KW = BK / 4;              // 32-bit words per staged tile row
constexpr int ROW_W = KW + 1;           // padded row (9 words): no bank conflicts
constexpr int ROW_B = ROW_W * 4;        // the padded row in bytes

__global__ void __launch_bounds__(THREADS)
vta_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const int32_t* __restrict__ bias, void* __restrict__ out,
                int m, int k, int n, int relu, int shift, int saturate,
                int out_int8) {
  // A tile row-major; B tile transposed ([n][k]) so that four consecutive
  // k of one column form one 32-bit word, as they do for a row of A.
  __shared__ int32_t a_s[BM][ROW_W];
  __shared__ int32_t b_s[BN][ROW_W];
  int8_t* a_s8 = reinterpret_cast<int8_t*>(&a_s[0][0]);
  int8_t* b_s8 = reinterpret_cast<int8_t*>(&b_s[0][0]);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * BN;

  // Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j: neighbouring
  // threads write neighbouring columns, and the b_s reads of a warp fall
  // in distinct banks (9 * tx mod 32 is distinct for tx < 16).
  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A: BM x BK bytes; consecutive threads read consecutive k of a row.
#pragma unroll
    for (int s = 0; s < (BM * BK) / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int64_t gr = row0 + r;
      const int gc = k0 + c;
      int8_t v = 0;
      if (gr < m && gc < k) v = a[gr * k + gc];
      a_s8[r * ROW_B + c] = v;
    }
    // B: BK x BN bytes; consecutive threads read consecutive n of a row.
#pragma unroll
    for (int s = 0; s < (BK * BN) / THREADS; ++s) {
      const int e = tid + s * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int64_t gc = col0 + c;
      int8_t v = 0;
      if (gk < k && gc < n) v = b[static_cast<int64_t>(gk) * n + gc];
      b_s8[c * ROW_B + r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int32_t av[4];
      int32_t bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Fused epilogue: bias (wrapping), relu, arithmetic shift, commit.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (c >= n) continue;
      uint32_t u = static_cast<uint32_t>(acc[i][j]);
      if (bias != nullptr) u += static_cast<uint32_t>(bias[c]);
      int32_t v = static_cast<int32_t>(u);
      if (relu && v < 0) v = 0;
      v >>= shift;
      if (out_int8) {
        if (saturate) v = v < -128 ? -128 : (v > 127 ? 127 : v);
        static_cast<int8_t*>(out)[r * n + c] =
            static_cast<int8_t>(static_cast<uint8_t>(v & 0xFF));
      } else {
        static_cast<int32_t*>(out)[r * n + c] = v;
      }
    }
  }
}

}  // namespace

extern "C" int vta_gemm_launch(const void* a, const void* b, const void* bias,
                               void* out, int m, int k, int n, int relu,
                               int shift, int saturate, int out_int8,
                               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  vta_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(bias), out, m, k, n, relu, shift, saturate,
      out_int8);
  return static_cast<int>(cudaGetLastError());
}
