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
// signed integers that can overflow: the products are summed by
// mma.sync ... .s32.s8.s8.s32 without .satfinite (whose int32 accumulate
// wraps; .satfinite would clamp), the partial sums of warps that split K
// and the bias are added in uint32_t, and the int8 truncation is
// (int8_t)(uint8_t)(v & 0xFF).
//
// What bounds it on an H100.  LeNet-5's GEMMs at batch 32 (25088x32x16,
// 3584x160x16, 32x400x128, 32x128x96, 32x96x16) and resnet8's (up to
// 32768x144x16 and 2048x576x64) move at most a few MB and do at most
// ~150 M int8 MACs: the bytes bound (3.35 TB/s) is under a microsecond to
// a few microseconds and the int8 tensor-core bound far below it.  What
// the first port (64x64 tiles, byte loads 32 K-bytes at a time, __dp4a)
// lost was latency and idle SMs, not arithmetic.  The design answers its
// three causes:
//
//  1. One tile for every GEMM.  The geometry now comes from
//     kernels/vta_gemm.py:plan, which sizes the tile to the GEMM (bm in
//     {16, 32, 64, 128} rows, bn in {16, 32, 64} columns): the largest
//     whose grid still holds three quarters of a wave of blocks, and a
//     K range split over warp groups (k_split) whose partial sums meet in
//     shared memory, so that a block runs up to 8 warps.  This library
//     holds one instantiation per (bm, bn, k_split, load path) with at
//     most 8 warps and refuses any other geometry
//     (cudaErrorInvalidValue): there is no second chooser here.
//  2. One memory round trip per 32 K-bytes.  On the vec16 path (K and N
//     multiples of 16, operands 16-byte aligned) a block issues its A and
//     B tiles as 16-byte cp.async.cg copies into a ring of up to 8 stages
//     that holds a LeNet-5 or resnet8 block's whole K range, so a launch
//     waits for memory about once.  Ragged shapes take the bytes path:
//     masked byte loads into the same layout, in the same kernel.
//  3. CUDA-core dp4a.  Products run on the int8 tensor cores,
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, one warp per 16
//     rows and all bn columns of its K slice.  A fragments come from
//     ldmatrix.x4.  B arrives (K, N) row-major, but the .col fragment wants
//     four consecutive k of one column in a register: B rows are stored
//     in shared memory in a permuted k order so that one ldmatrix.x4.trans
//     (16-bit elements: pairs of columns) plus four byte permutes gives the
//     fragments of two n8 tiles, the even and the odd columns of a 16-
//     column chunk.  The epilogue undoes that interleave: each thread holds
//     four consecutive columns of two rows.  Shared-memory rows are padded
//     to an odd multiple of 16 bytes, so ldmatrix reads do not conflict.
//
// wgmma is not used: its 64-row tile would waste half of its rows at
// M = 32 (LeNet-5's l3-l5), and no shape here is bound by the tensor-core
// rate.  The epilogue is fused (bias, relu, shift, commit) and writes each
// output byte once: no atomics, no second pass, one launch per call.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KSTEP = 32;           // K bytes of one mma (m16n8k32)
constexpr int MAX_STAGES = 8;       // cp.async groups a block keeps in flight
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use

// Bytes of a B row in shared memory: an odd multiple of 16 (conflict-free
// ldmatrix); 16 columns need no pad.
__host__ __device__ constexpr int b_pitch(int bn) {
  return bn == 16 ? 16 : bn + 16;
}
// Bytes of an A row of a stage of bk K-bytes (bk a power of two, >= 32).
__host__ __device__ constexpr int a_pitch(int bk) { return bk + 16; }

// The shared-memory row of the k-th row of a stage's B tile.  Within each
// 32-byte K step, k = 16 h + 4 t + j goes to row 16 h + 8 (j / 2) + 2 t +
// (j % 2): ldmatrix.trans then hands thread t the rows of k = 4 t + j.
__device__ __forceinline__ int b_row(int kk) {
  const int w = kk & 31;
  const int j = w & 3;
  return (kk & ~31) + (w & 16) + ((j >> 1) << 3) + (((w >> 2) & 3) << 1) +
         (j & 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0..MAX_STAGES-1) groups are in flight; the
// instruction takes an immediate.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x32, row) * b (32x8, col): int8 in, int32 accumulate that wraps.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Epilogue {
  int relu, shift, saturate, out_int8;
};

__device__ __forceinline__ int32_t epilogue(int32_t acc, int32_t bias,
                                            const Epilogue& e) {
  int32_t v = static_cast<int32_t>(static_cast<uint32_t>(acc) +
                                   static_cast<uint32_t>(bias));
  if (e.relu && v < 0) v = 0;
  v >>= e.shift;
  if (e.out_int8 && e.saturate) v = v < -128 ? -128 : (v > 127 ? 127 : v);
  return v;
}

__device__ __forceinline__ uint32_t low_byte(int32_t v) {
  return static_cast<uint32_t>(v) & 0xFFu;
}

// One block computes a bm x bn output tile over the whole of K.  Warp w
// owns rows 16 (w % WM) .. +15 and the K steps j == w / WM (mod KS) of
// every stage.  The minimum of one block an SM in __launch_bounds__ and
// the loops kept rolled (unroll 1) keep ptxas from spilling (it spilled
// 4-20 bytes at bn = 64 without them).
template <int BM, int BN, int KS, bool VEC>
__global__ void __launch_bounds__(32 * (BM / 16) * KS, 1)
vta_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                const int32_t* __restrict__ bias, void* __restrict__ out,
                int m, int k, int n, Epilogue e, int bk, int stages) {
  constexpr int WM = BM / 16;               // warps along M
  constexpr int THREADS = 32 * WM * KS;
  constexpr int CHUNKS = BN / 16;           // 16-column chunks
  constexpr int SB = b_pitch(BN);
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, kid = warp / WM;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  const int ap = a_pitch(bk);
  const int stage_bytes = BM * ap + bk * SB;
  const int nst = (k + bk - 1) / bk;        // stages of K

  // Stage s of K into ring slot `slot`: A rows row0.., B rows permuted by
  // b_row; whatever lies past M, N or K is zero.
  auto load = [&](int s, int slot) {
    uint8_t* as = smem + slot * stage_bytes;
    uint8_t* bs = as + BM * ap;
    const int k0 = s * bk;
    if constexpr (VEC) {
      // Each thread copies one 16-byte column of A and of B, every
      // THREADS / ach-th row: ach (a power of two) divides THREADS.
      const int ach = bk / 16, c = tid & (ach - 1), gk = k0 + 16 * c;
#pragma unroll 1
      for (int r = tid / ach; r < BM; r += THREADS / ach) {
        const long long gr = row0 + r;
        const bool ok = gr < m && gk < k;
        cp_async16(as + r * ap + 16 * c, ok ? a + gr * k + gk : a, ok);
      }
      const int cb = tid % CHUNKS, gc = col0 + 16 * cb;
#pragma unroll 1
      for (int kk = tid / CHUNKS; kk < bk; kk += THREADS / CHUNKS) {
        const int gkb = k0 + kk;
        const bool ok = gkb < k && gc < n;
        cp_async16(bs + b_row(kk) * SB + 16 * cb,
                   ok ? b + static_cast<long long>(gkb) * n + gc : b, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < BM * bk; i += THREADS) {
        const int r = i / bk, kk = i - r * bk;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        as[r * ap + kk] =
            (gr < m && gk < k) ? static_cast<uint8_t>(a[gr * k + gk]) : 0;
      }
#pragma unroll 1
      for (int i = tid; i < bk * BN; i += THREADS) {
        const int kk = i / BN, c = i - kk * BN;
        const int gk = k0 + kk, gc = col0 + c;
        bs[b_row(kk) * SB + c] =
            (gk < k && gc < n)
                ? static_cast<uint8_t>(b[static_cast<long long>(gk) * n + gc])
                : 0;
      }
    }
  };

  int32_t acc[CHUNKS][2][4];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][h][i] = 0;

  // The ring: stages - 1 in flight before the first product; each step
  // issues the stage that reuses the slot freed one step before.
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nst) load(s, s);
    if constexpr (VEC) cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    const int next = s + stages - 1;
    if (next < nst) load(next, next % stages);
    if constexpr (VEC) {
      cp_async_commit();
      cp_async_wait(stages - 1);
    }
    __syncthreads();
    const uint8_t* as = smem + (s % stages) * stage_bytes;
    const uint8_t* bs = as + BM * ap;
    const int steps = (min(bk, k - s * bk) + KSTEP - 1) / KSTEP;
#pragma unroll 1
    for (int j = kid; j < steps; j += KS) {
      uint32_t af[4];
      ldmatrix_x4(af, as + (wm * 16 + (lane & 15)) * ap + j * KSTEP +
                          (lane >> 4) * 16);
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (j * KSTEP + lane) * SB + c * 16);
        mma_s8(acc[c][0], af, __byte_perm(r[0], r[1], 0x6420),
               __byte_perm(r[2], r[3], 0x6420));
        mma_s8(acc[c][1], af, __byte_perm(r[0], r[1], 0x7531),
               __byte_perm(r[2], r[3], 0x7531));
      }
    }
    __syncthreads();
  }

  // Warps that split K add their partial sums (uint32_t, wrapping) into
  // the first warp of their rows, through the freed ring.
  if constexpr (KS > 1) {
    uint32_t* red = reinterpret_cast<uint32_t*>(smem);
    // Partial sums of (warp q, rows wm): CHUNKS x 2 x 4 words per lane.
    auto slot = [&](int q, int c, int h, int i) {
      return ((((q - 1) * WM + wm) * CHUNKS + c) * 8 + h * 4 + i) * 32 + lane;
    };
    if (kid > 0) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[slot(kid, c, h, i)] = static_cast<uint32_t>(acc[c][h][i]);
    }
    __syncthreads();
    if (kid > 0) return;
#pragma unroll
    for (int q = 1; q < KS; ++q)
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[c][h][i] = static_cast<int32_t>(
                static_cast<uint32_t>(acc[c][h][i]) + red[slot(q, c, h, i)]);
  }

  // Fused epilogue.  Chunk c's even tile holds columns n0 + 2 j, its odd
  // tile n0 + 2 j + 1, so thread (g, t) holds columns n0 + 4 t .. + 3 of
  // rows g and g + 8.
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int nc = col0 + 16 * c + 4 * t;
    int32_t bv[4] = {0, 0, 0, 0};
    if (bias != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nc + i < n) bv[i] = bias[nc + i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + wm * 16 + g + 8 * h;
      if (r >= m) continue;
      const int32_t v[4] = {epilogue(acc[c][0][2 * h], bv[0], e),
                            epilogue(acc[c][1][2 * h], bv[1], e),
                            epilogue(acc[c][0][2 * h + 1], bv[2], e),
                            epilogue(acc[c][1][2 * h + 1], bv[3], e)};
      const long long o = r * n + nc;
      if (VEC && nc < n) {          // N % 16 == 0: the 4 columns are whole
        if (e.out_int8)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
              low_byte(v[0]) | low_byte(v[1]) << 8 | low_byte(v[2]) << 16 |
              low_byte(v[3]) << 24;
        else
          *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + o) =
              make_int4(v[0], v[1], v[2], v[3]);
      } else if (!VEC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (nc + i >= n) break;
          if (e.out_int8)
            static_cast<int8_t*>(out)[o + i] =
                static_cast<int8_t>(static_cast<uint8_t>(low_byte(v[i])));
          else
            static_cast<int32_t*>(out)[o + i] = v[i];
        }
      }
    }
  }
}

// The launch geometry that vta_gemm.plan chose (field order as
// GemmPlan.c_plan in kernels/vta_gemm.py; vec16 is the load path).
struct Plan {
  int bm, bn, k_split, bk, stages, vec16, smem, gx, gy;
};

struct Args {
  const int8_t *a, *b;
  const int32_t* bias;
  void* out;
  int m, k, n;
  Epilogue e;
  Plan p;
  cudaStream_t stream;
};

// What the kernel's shared memory must hold for plan p: the ring, or the
// partial sums of the warps that split K, whichever is larger.
long long smem_bytes(const Plan& p) {
  const long long ring = static_cast<long long>(p.stages) *
                         (p.bm * a_pitch(p.bk) + p.bk * b_pitch(p.bn));
  const long long red = static_cast<long long>(p.k_split - 1) * p.bm * p.bn * 4;
  return ring > red ? ring : red;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <int BM, int BN, int KS, bool VEC>
cudaError_t launch(const Args& a) {
  const Plan& p = a.p;
  // bk: a power of two from one K step a group up to 256, so that its
  // 16-byte columns (bk / 16 <= 16) divide the block's 32 or more threads.
  if (p.bk < KSTEP * KS || (p.bk & (p.bk - 1)) != 0 || p.bk > 256 ||
      p.stages < 1 || p.stages > MAX_STAGES || p.smem != smem_bytes(p) ||
      p.smem > SMEM_LIMIT ||
      p.gx != (static_cast<long long>(a.m) + BM - 1) / BM ||
      p.gy != (static_cast<long long>(a.n) + BN - 1) / BN || p.gy > 65535)
    return cudaErrorInvalidValue;
  if (VEC && (a.k % 16 != 0 || a.n % 16 != 0 || !aligned16(a.a) ||
              !aligned16(a.b) || !aligned16(a.out)))
    return cudaErrorInvalidValue;
  auto kernel = vta_gemm_kernel<BM, BN, KS, VEC>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.gx, p.gy), 32 * (BM / 16) * KS, p.smem, a.stream>>>(
      a.a, a.b, a.bias, a.out, a.m, a.k, a.n, a.e, p.bk, p.stages);
  return cudaGetLastError();
}

// The instantiations: every tile (bm, bn) with every K split of at most 8
// warps a block, each on both load paths.  kernels/vta_gemm.py declares
// the same list as GEOMETRIES; the CPU tests read this table and compare.
#define VTA_GEMM_GEOMETRIES(X) \
  X(16, 16, 1)               \
  X(16, 16, 2)               \
  X(16, 16, 4)               \
  X(16, 16, 8)               \
  X(16, 32, 1)               \
  X(16, 32, 2)               \
  X(16, 32, 4)               \
  X(16, 32, 8)               \
  X(16, 64, 1)               \
  X(16, 64, 2)               \
  X(16, 64, 4)               \
  X(16, 64, 8)               \
  X(32, 16, 1)               \
  X(32, 16, 2)               \
  X(32, 16, 4)               \
  X(32, 32, 1)               \
  X(32, 32, 2)               \
  X(32, 32, 4)               \
  X(32, 64, 1)               \
  X(32, 64, 2)               \
  X(32, 64, 4)               \
  X(64, 16, 1)               \
  X(64, 16, 2)               \
  X(64, 32, 1)               \
  X(64, 32, 2)               \
  X(64, 64, 1)               \
  X(64, 64, 2)               \
  X(128, 16, 1)              \
  X(128, 32, 1)              \
  X(128, 64, 1)

cudaError_t dispatch(const Args& a) {
  const Plan& p = a.p;
#define VTA_GEMM_CASE(BM_, BN_, KS_)                                   \
  if (p.bm == BM_ && p.bn == BN_ && p.k_split == KS_)                  \
    return p.vec16 ? launch<BM_, BN_, KS_, true>(a)                    \
                   : launch<BM_, BN_, KS_, false>(a);
  VTA_GEMM_GEOMETRIES(VTA_GEMM_CASE)
#undef VTA_GEMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches plan `plan` (a struct Plan) on `stream`.  Returns a cudaError_t,
// 0 on success; a plan with no instantiation, or one that does not match
// the shape, is refused with cudaErrorInvalidValue before any launch.
extern "C" int vta_gemm_launch(const void* a, const void* b, const void* bias,
                               void* out, int m, int k, int n, int relu,
                               int shift, int saturate, int out_int8,
                               const void* plan, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (plan == nullptr || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const int8_t*>(a),
                  static_cast<const int8_t*>(b),
                  static_cast<const int32_t*>(bias),
                  out,
                  m,
                  k,
                  n,
                  Epilogue{relu, shift, saturate, out_int8},
                  *static_cast<const Plan*>(plan),
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(args));
}
