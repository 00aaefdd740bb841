// vta_alu.cu - the VTA's TensorAlu epilogue over a batch of DRAM images, one
// launch a layer, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this epilogue in numpy around
// its Pallas GEMM (src/repro/core/pallas_backend.py, apply_alu_epilogue).
// The port's plain version is core/cuda_backend.py's apply_alu_epilogue,
// which the CPU path runs and this kernel is held to on the card.  It was
// added because that plain version, run on the card, made a full pass over
// device memory for every ALU op (each widened to int64 and wrapped back).
//
// For every image b of the batch, over the program's n_vec result vectors
// of bs int32 lanes (block-major, the order the VTA's ALU indexes):
//
//   x    = wrap32(gemm[b] + ACC[b])     the GEMM's int32 result, X preloaded
//   x    = op_k(x)  for each op of the program, in order
//   OUT[b] = commit(x)                  §2.1 truncation, or the clip when
//                                        saturate
//
//   gemm   int32 (B, Mp, Np) row-major: vta_gemm's int32 output, whose
//          (v, lane) element sits at row (v / (beta*rh))*rh + v % rh,
//          column ((v / rh) % beta)*bs + lane
//   stack  uint8 (B, row_stride): the DRAM images; ACC and RES are int32
//          and OUT int8 in the §3.2 block layout, which is vector order:
//          element (v, lane) at v*bs + lane
//   acc    uint8: the one image whose ACC every image of the batch reads
//          (the compiled image's bias preload)
//   table  int64: the program, ROW words an op (see Kind), then the
//          index data of indexed and pair ops
//
// Each op computes in int64 in registers and wraps to int32 after it, as
// the plain version does in int64 tensors: immediate MIN/MAX/ADD/SHR (a
// shift count outside [0, 63] shifts by 63, as torch's >> does), the
// residual op against RES (an optional pre-shift of RES first), pair ops
// dst = op(dst, src) (a vector shift takes its count & 31) and indexed
// immediate ops.  The lanes of a vector never mix: every op is lane-wise.
//
// What bounds it on an H100: bytes.  Each element is read once from the
// GEMM's result, ACC and RES and written once to OUT as a byte: 13 bytes
// an element with RES, 9 without, at 3.35 TB/s; the arithmetic is a few
// integer operations an element.  The batch shares one ACC: every image
// reads the same bytes, which L2 can serve after the first images where
// they fit.  The design moves those bytes once:
//
//  * a program of element-wise ops only (immediate and residual ops)
//    streams: one thread takes 4 lanes of a vector, loads them with one
//    16-byte load from each of the GEMM's result, ACC and RES, runs the
//    whole program in registers and stores 4 OUT bytes; no shared memory.
//  * a program with pair or indexed ops (pooling, the GAP tree) takes one
//    block an image.  The block loads the image's vectors once, with the
//    ACC preload and the program's leading element-wise ops applied on
//    the way, into shared memory (bs * 4 bytes a vector), runs the other
//    ops there with a barrier after each, and runs the trailing
//    element-wise ops and the commit on the way out to OUT.  An image too
//    large for shared memory works in place in the GEMM's result instead
//    (the same steps in device memory; the result is the wrapper's
//    scratch).
//
// Pair ops come from the table in one of two forms.  PAIR: no src is a dst
// (the lattices of pooling and of the GAP tree), grouped by dst, so one
// thread a (dst, lane) folds its srcs into dst: duplicate dsts merge as the
// plain version's index_add_ (ADD, wrapped once at the end) and
// scatter_reduce_ (MIN, MAX) merge them.  PAIR_SEQ: pairs that read what an
// earlier pair wrote, applied in order by one thread a lane.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 8;              // int64 words an op takes in the table
constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use

// an op row: kind, ALU op, imm (the pre-shift of RES), then by kind
//   INDEXED   [3] first index word, [4] indices
//   PAIR      [3] first dst word, [4] dsts, [5] first offset word (dsts + 1
//             offsets into the srcs), [6] first src word
//   PAIR_SEQ  [3] first word of the (dst, src) pairs, [4] pairs
enum Kind : int { IMM = 0, RES = 1, INDEXED = 2, PAIR = 3, PAIR_SEQ = 4 };
enum Op : int { MIN = 0, MAX = 1, ADD = 2, SHR = 3 };
enum Mode : int { STREAM = 0, SHARED = 1, GLOBAL = 2 };

struct Args {
  int32_t* gemm;
  uint8_t* stack;
  long long row_stride;             // bytes from one image to the next
  const uint8_t* acc;               // the image ACC is read from
  long long acc_off, res_off, out_off;  // region starts; -1 for no region
  const long long* table;
  int n_ops, lead, tail;            // ops [0, lead) and [tail, n_ops) are
                                    // element-wise
  int alpha, beta, rh, bs;
  int saturate;
};

__device__ __forceinline__ int32_t wrap32(long long x) {
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<unsigned long long>(x)));
}

__device__ __forceinline__ long long shr_imm(long long a, long long s) {
  return a >> ((s < 0 || s > 63) ? 63 : s);
}

__device__ __forceinline__ long long imm_apply(int op, long long a,
                                               long long imm) {
  switch (op) {
    case MIN: return a < imm ? a : imm;
    case MAX: return a > imm ? a : imm;
    case ADD: return static_cast<long long>(
        static_cast<unsigned long long>(a) + static_cast<unsigned long long>(imm));
    default: return shr_imm(a, imm);
  }
}

// a vector-vector op on int32 values held in int64 (pair and residual ops)
__device__ __forceinline__ long long vec_apply(int op, long long a,
                                               long long b) {
  switch (op) {
    case MIN: return a < b ? a : b;
    case MAX: return a > b ? a : b;
    case ADD: return a + b;
    default: return a >> (b & 31);
  }
}

// (v, lane) of an image -> its element in the GEMM's (Mp, Np) result
__device__ __forceinline__ int gemm_index(const Args& a, int v, int lane) {
  const int per_row = a.beta * a.rh;            // vectors in a block row
  const int i = v / per_row;
  const int rem = v - i * per_row;
  const int j = rem / a.rh;
  const int r = rem - j * a.rh;
  return ((i * a.rh + r) * a.beta + j) * a.bs + lane;
}

template <int VEC>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

// ACC and RES: read-only for the whole launch
template <int VEC>
__device__ __forceinline__ void load_ro(const int32_t* p, int32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(int32_t* p, const int32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ uint32_t commit(int32_t x, int saturate) {
  if (saturate) x = x < -128 ? -128 : (x > 127 ? 127 : x);
  return static_cast<uint32_t>(x) & 0xFFu;
}

template <int VEC>
__device__ __forceinline__ void store_out(uint8_t* p, const int32_t (&x)[VEC],
                                          int saturate) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        commit(x[0], saturate) | commit(x[1], saturate) << 8 |
        commit(x[2], saturate) << 16 | commit(x[3], saturate) << 24;
  } else {
    *p = static_cast<uint8_t>(commit(x[0], saturate));
  }
}

// the ACC region every image reads (null without one)
__device__ __forceinline__ const int32_t* acc_of(const Args& a) {
  return a.acc_off >= 0
      ? reinterpret_cast<const int32_t*>(a.acc + a.acc_off)
      : nullptr;
}

// the GEMM's result at element e of an image, with the ACC preload `acc`
// (the image's ACC region; null without one)
template <int VEC>
__device__ __forceinline__ void load_result(const Args& a, const int32_t* gemm,
                                            const int32_t* acc, int e,
                                            int32_t (&x)[VEC]) {
  const int v = e / a.bs;
  load<VEC>(gemm + gemm_index(a, v, e - v * a.bs), x);
  if (acc != nullptr) {
    int32_t p[VEC];
    load_ro<VEC>(acc + e, p);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      x[j] = wrap32(static_cast<long long>(x[j]) + p[j]);
  }
}

// ops [lo, hi) of the table, all immediate or residual, on VEC lanes at
// element e; `res` is the image's RES region (null without one)
template <int VEC>
__device__ __forceinline__ void elementwise(const Args& a, int lo, int hi,
                                            int32_t (&x)[VEC],
                                            const int32_t* res, int e) {
  for (int i = lo; i < hi; ++i) {
    const long long* row = a.table + i * ROW;
    const int kind = static_cast<int>(__ldg(row));
    const int op = static_cast<int>(__ldg(row + 1));
    const long long imm = __ldg(row + 2);
    if (kind == IMM) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = wrap32(imm_apply(op, x[j], imm));
    } else {
      int32_t r[VEC];
      load_ro<VEC>(res + e, r);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        long long rr = r[j];
        if (imm != 0) rr = wrap32(shr_imm(rr, imm));
        x[j] = wrap32(vec_apply(op, x[j], rr));
      }
    }
  }
}

__device__ __forceinline__ const int32_t* res_of(const Args& a,
                                                 const uint8_t* img) {
  return a.res_off >= 0
      ? reinterpret_cast<const int32_t*>(img + a.res_off) : nullptr;
}

// Element-wise programs: one thread VEC lanes of one vector, the grid
// `chunks` blocks an image.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
vta_alu_stream(Args a, int chunks) {
  const int n = a.alpha * a.beta * a.rh * a.bs;
  const long long b = blockIdx.x / chunks;
  const int it = static_cast<int>(blockIdx.x - b * chunks) * THREADS
      + threadIdx.x;
  if (it >= n / VEC) return;
  const int e = it * VEC;
  uint8_t* img = a.stack + b * a.row_stride;
  int32_t x[VEC];
  load_result<VEC>(a, a.gemm + b * n, acc_of(a), e, x);
  elementwise<VEC>(a, 0, a.n_ops, x, res_of(a, img), e);
  store_out<VEC>(img + a.out_off + e, x, a.saturate);
}

// Programs with pair or indexed ops: one block an image, its vectors in
// shared memory (IN_SHARED) or in place in the GEMM's result.
template <int VEC, bool IN_SHARED>
__global__ void __launch_bounds__(THREADS)
vta_alu_image(Args a) {
  extern __shared__ int4 smem4[];
  const int n = a.alpha * a.beta * a.rh * a.bs;
  const int bs = a.bs;
  const long long b = blockIdx.x;
  int32_t* gemm = a.gemm + b * n;
  uint8_t* img = a.stack + b * a.row_stride;
  const int32_t* acc = acc_of(a);
  const int32_t* res = res_of(a, img);
  int32_t* work = IN_SHARED ? reinterpret_cast<int32_t*>(smem4) : gemm;
  auto slot = [&](int v, int lane) {
    return IN_SHARED ? v * bs + lane : gemm_index(a, v, lane);
  };

  for (int e = threadIdx.x * VEC; e < n; e += THREADS * VEC) {
    int32_t x[VEC];
    load_result<VEC>(a, gemm, acc, e, x);
    elementwise<VEC>(a, 0, a.lead, x, res, e);
    const int v = e / bs;
    store<VEC>(work + slot(v, e - v * bs), x);
  }
  __syncthreads();

  for (int i = a.lead; i < a.tail; ++i) {
    const long long* row = a.table + i * ROW;
    const int kind = static_cast<int>(__ldg(row));
    const int op = static_cast<int>(__ldg(row + 1));
    const long long imm = __ldg(row + 2);
    const long long* data = a.table + __ldg(row + 3);
    const int count = static_cast<int>(__ldg(row + 4));
    if (kind == IMM || kind == RES) {
      for (int e = threadIdx.x; e < n; e += THREADS) {
        const int v = e / bs;
        int32_t* p = work + slot(v, e - v * bs);
        int32_t x[1] = {*p};
        elementwise<1>(a, i, i + 1, x, res, e);
        *p = x[0];
      }
    } else if (kind == INDEXED) {
      for (int t = threadIdx.x; t < count * bs; t += THREADS) {
        const int k = t / bs;
        int32_t* p = work + slot(static_cast<int>(__ldg(data + k)),
                                 t - k * bs);
        *p = wrap32(imm_apply(op, *p, imm));
      }
    } else if (kind == PAIR) {
      const long long* offsets = a.table + __ldg(row + 5);
      const long long* srcs = a.table + __ldg(row + 6);
      for (int t = threadIdx.x; t < count * bs; t += THREADS) {
        const int k = t / bs;
        const int lane = t - k * bs;
        int32_t* p = work + slot(static_cast<int>(__ldg(data + k)), lane);
        long long acc = *p;
        const int end = static_cast<int>(__ldg(offsets + k + 1));
        for (int q = static_cast<int>(__ldg(offsets + k)); q < end; ++q)
          acc = vec_apply(op, acc,
                          work[slot(static_cast<int>(__ldg(srcs + q)), lane)]);
        *p = wrap32(acc);
      }
    } else {                        // PAIR_SEQ
      for (int lane = threadIdx.x; lane < bs; lane += THREADS) {
        for (int q = 0; q < count; ++q) {
          int32_t* p = work + slot(static_cast<int>(__ldg(data + 2 * q)), lane);
          const int32_t s =
              work[slot(static_cast<int>(__ldg(data + 2 * q + 1)), lane)];
          *p = wrap32(vec_apply(op, *p, s));
        }
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x * VEC; e < n; e += THREADS * VEC) {
    const int v = e / bs;
    int32_t x[VEC];
    load<VEC>(work + slot(v, e - v * bs), x);
    elementwise<VEC>(a, a.tail, a.n_ops, x, res, e);
    store_out<VEC>(img + a.out_off + e, x, a.saturate);
  }
}

template <int VEC>
cudaError_t launch(const Args& a, int mode, int batch, int smem,
                   cudaStream_t stream) {
  const int n = a.alpha * a.beta * a.rh * a.bs;
  if (mode == STREAM) {
    const int chunks = (n / VEC + THREADS - 1) / THREADS;
    vta_alu_stream<VEC><<<static_cast<unsigned>(batch) * chunks, THREADS, 0,
                          stream>>>(a, chunks);
  } else if (mode == SHARED) {
    // The limit is the most any image may take, never this launch's own
    // size: layers of other sizes launch from other threads at once, and a
    // smaller limit set between another thread's call and its launch would
    // refuse that launch.
    cudaError_t err = cudaFuncSetAttribute(
        vta_alu_image<VEC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    vta_alu_image<VEC, true><<<batch, THREADS, smem, stream>>>(a);
  } else {
    vta_alu_image<VEC, false><<<batch, THREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// mode: 0 stream, 1 one block an image in `smem` bytes of shared memory,
// 2 one block an image in place in `gemm`; vec: 4 (16-byte loads: every
// region start, the row stride and bs multiples of 16, 16 and 4 bytes)
// or 1.  `acc`: the one image ACC is read from.  Anything else is refused
// with cudaErrorInvalidValue before a launch.
extern "C" int vta_alu_launch(void* gemm, void* stack, long long row_stride,
                              const void* acc, long long acc_off,
                              long long res_off, long long out_off,
                              const void* table, int n_ops,
                              int lead, int tail, int batch, int alpha,
                              int beta, int rh, int bs, int saturate,
                              int mode, int vec, int smem, void* stream) {
  const long long n = 1LL * alpha * beta * rh * bs;
  const long long chunks = (n / vec + THREADS - 1) / THREADS;
  const bool ok = batch > 0 && n > 0 && n < (1LL << 31) && n % vec == 0 &&
      (acc_off < 0 || acc != nullptr) &&
      (vec == 1 || vec == 4) && 0 <= lead && lead <= tail && tail <= n_ops &&
      (mode == STREAM ? lead == n_ops && batch * chunks < (1LL << 31)
                      : mode == GLOBAL || (mode == SHARED && smem == n * 4 &&
                                           smem <= SMEM_LIMIT));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<int32_t*>(gemm), static_cast<uint8_t*>(stack),
               row_stride, static_cast<const uint8_t*>(acc), acc_off, res_off,
               out_off,
               static_cast<const long long*>(table), n_ops, lead, tail,
               alpha, beta, rh, bs, saturate};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec == 4 ? launch<4>(a, mode, batch, smem, s)
                                   : launch<1>(a, mode, batch, smem, s));
}
