// vta_stage.cu - a layer's GEMM operand, or its RES region, gathered in one
// pass from the bytes its producer committed, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference stages every layer on the host in
// numpy between VTA executions (src/repro/core/network_compiler.py,
// _stage_layer_input_batch and _stage_residual_batch over
// conv_lowering.im2row_batch, layout.batch_matrix_to_binary and
// simulator.decode_out_region_batch).  The port ran the same steps as a
// chain of PyTorch copies on the card (OUT decoded to NCHW, im2row, the
// pad, the tiled pool's rows, the block-major INP write, INP decoded back
// into the kernel's operand), each a full pass over device memory; this
// kernel replaces the chain.  Its plain version is ref.vta_stage_ref.
//
// For every image b of the batch and destination element i:
//
//   dst[b][i] = tbl[i] < 0 ? 0 : src[b][tbl[i]]
//
//   src   int8 rows (a DRAM stack row, whose producer's OUT region the
//         table reads, or an input image), row_stride bytes apart
//   dst   int8 elements (ELEM 1: the (Mp, Kp) operand of vta_gemm, or an
//         INP region) or int32 ones (ELEM 4: a RES region, each source
//         byte sign-extended), dst_stride bytes from one image to the next
//   tbl   int32, one source byte a destination element, -1 for a zero
//         (padding, the tiled pool's empty rows, the pad rows and columns)
//   runs  int32, one word a 16-byte destination chunk: the chunk's first
//         source byte where its sources are one run of consecutive bytes
//         aligned to the run's length (16 sources for int8, 4 for int32),
//         else -1; read from the table when it is built (1x1 stride-1
//         convs, the RES of a join)
//
// The table is built once per compiled network (core/staging.py runs the
// port's torch staging functions over an index tensor), so the layout has
// one definition and the kernel knows nothing of convolutions.
//
// What bounds it on an H100: bytes.  Each destination byte is written once
// and each source byte need be read once from device memory, at 3.35 TB/s;
// there is no arithmetic.  The design:
//
//  * one thread writes one 16-byte destination chunk with one store: 16
//    int8 elements or 4 int32 ones;
//  * a block holds one tile of table entries in registers (a thread its
//    chunk's entries and run word) and walks a group of the batch's images
//    with it, so the table is read once for a group of images, not once an
//    image;
//  * the destination is `rows` rows of `cols` chunks (the operand: Mp rows
//    of Kp / 16; a block-ordered region: one column).  A block's tile is
//    tile_rows rows by tile_cols columns, and consecutive threads
//    take consecutive rows: neighbouring im2row rows read neighbouring
//    source pixels, which the producer's OUT blocks keep 16 bytes apart, so
//    a warp's loads of one entry fall in a few cache lines, and a 3x3
//    conv's nine reads of each source byte hit L1 or L2;
//  * a chunk whose sources are one aligned run is one 16-byte (int8) or
//    4-byte (int32) load.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16;           // destination bytes a thread stores

struct Args {
  const int8_t* src;
  long long src_stride;             // bytes from one source row to the next
  uint8_t* dst;
  long long dst_stride;             // bytes from one image's destination to
                                    // the next
  const int32_t* tbl;
  const int32_t* runs;              // null: every chunk gathers by entry
  int rows, cols;                   // the destination's chunks
  int tile_rows, tile_cols;         // a block's tile of chunks
  int tiles_c;                      // tiles across a row of chunks
  int batch, per_block;             // images; images a block walks
};

__device__ __forceinline__ uint32_t byte_of(const int8_t* s, int at) {
  return at < 0 ? 0u : static_cast<uint32_t>(static_cast<uint8_t>(s[at]));
}

__device__ __forceinline__ int sext_of(const int8_t* s, int at) {
  return at < 0 ? 0 : static_cast<int>(s[at]);
}

// sign-extend byte k of a little-endian word
__device__ __forceinline__ int sext_byte(uint32_t w, int k) {
  return static_cast<int>(static_cast<int8_t>((w >> (8 * k)) & 0xFFu));
}

template <int ELEM>
__global__ void __launch_bounds__(THREADS) vta_stage_kernel(const Args a) {
  constexpr int E = CHUNK / ELEM;   // destination elements a chunk
  const int t = threadIdx.x;
  if (t >= a.tile_rows * a.tile_cols) return;
  const int tile = blockIdx.x;
  const int row = (tile / a.tiles_c) * a.tile_rows + t % a.tile_rows;
  const int col = (tile % a.tiles_c) * a.tile_cols + t / a.tile_rows;
  if (row >= a.rows || col >= a.cols) return;
  const long long c = 1LL * row * a.cols + col;

  const int run = a.runs != nullptr ? a.runs[c] : -1;
  int idx[E] = {};
  if (run < 0) {
    const int4* entries = reinterpret_cast<const int4*>(a.tbl) + c * (E / 4);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int4 v = entries[q];
      idx[4 * q] = v.x;
      idx[4 * q + 1] = v.y;
      idx[4 * q + 2] = v.z;
      idx[4 * q + 3] = v.w;
    }
  }

  const int b0 = blockIdx.y * a.per_block;
  const int b1 = min(a.batch, b0 + a.per_block);
  const int8_t* s = a.src + b0 * a.src_stride;
  uint8_t* d = a.dst + b0 * a.dst_stride + c * CHUNK;
#pragma unroll 2
  for (int b = b0; b < b1; ++b, s += a.src_stride, d += a.dst_stride) {
    int4 out;
    if constexpr (ELEM == 1) {
      if (run >= 0) {
        out = *reinterpret_cast<const int4*>(s + run);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = byte_of(s, idx[4 * q]) | byte_of(s, idx[4 * q + 1]) << 8 |
                 byte_of(s, idx[4 * q + 2]) << 16 |
                 byte_of(s, idx[4 * q + 3]) << 24;
        out = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                        static_cast<int>(w[2]), static_cast<int>(w[3]));
      }
    } else {
      if (run >= 0) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(s + run);
        out = make_int4(sext_byte(w, 0), sext_byte(w, 1), sext_byte(w, 2),
                        sext_byte(w, 3));
      } else {
        out = make_int4(sext_of(s, idx[0]), sext_of(s, idx[1]),
                        sext_of(s, idx[2]), sext_of(s, idx[3]));
      }
    }
    *reinterpret_cast<int4*>(d) = out;
  }
}

bool aligned(const void* p, long long n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// elem: 1 (int8 destination) or 4 (int32); tile_rows * tile_cols <=
// THREADS; groups blocks along the batch, each walking per_block images.
// `runs` may be null (then every chunk gathers by entry); where it is not,
// the source rows must allow 16-byte loads.  Anything else is refused with
// cudaErrorInvalidValue before a launch.
extern "C" int vta_stage_launch(const void* src, long long src_stride,
                                void* dst, long long dst_stride,
                                const void* tbl, const void* runs, int rows,
                                int cols, int tile_rows, int tile_cols,
                                int elem, int batch, int per_block,
                                void* stream) {
  const long long chunks = 1LL * rows * cols;
  const int tiles_r = tile_rows > 0 ? (rows + tile_rows - 1) / tile_rows : 0;
  const int tiles_c = tile_cols > 0 ? (cols + tile_cols - 1) / tile_cols : 0;
  const long long tiles = 1LL * tiles_r * tiles_c;
  const long long groups =
      per_block > 0 ? (batch + per_block - 1) / per_block : 0;
  const bool ok = (elem == 1 || elem == 4) && rows > 0 && cols > 0 &&
      batch > 0 && tile_rows > 0 && tile_cols > 0 &&
      tile_rows * tile_cols <= THREADS && chunks * (CHUNK / elem) < (1LL << 31) &&
      tiles < (1LL << 31) && groups > 0 && groups <= 65535 &&
      src != nullptr && dst != nullptr && tbl != nullptr &&
      aligned(dst, CHUNK) && dst_stride % CHUNK == 0 && aligned(tbl, 16) &&
      (runs == nullptr || (aligned(runs, 4) && aligned(src, CHUNK) &&
                           src_stride % CHUNK == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(src), src_stride,
               static_cast<uint8_t*>(dst), dst_stride,
               static_cast<const int32_t*>(tbl),
               static_cast<const int32_t*>(runs), rows, cols, tile_rows,
               tile_cols, tiles_c, batch, per_block};
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 1)
    vta_stage_kernel<1><<<grid, THREADS, 0, s>>>(a);
  else
    vta_stage_kernel<4><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
