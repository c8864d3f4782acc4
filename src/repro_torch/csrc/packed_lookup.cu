// Packed-clique gather, out[r] = table[ids[r]] for whole (omega, d) rows,
// and its unpacked baseline, out[r, o] = items[ids[r, o]] for d-wide rows:
// both are one row-copy engine, lookup_rows_launch, called with R rows of
// omega d elements or R omega rows of d elements.  The replay uses the
// packed gather once a partition stretch as the item -> clique-id lookup
// (table = clique_of reshaped to (n, 1, 1) int32); the kernel benchmark
// sets the two against each other.
//
// Replaces the TPU kernels repro/kernels/packed_lookup.py::packed_lookup
// (Pallas body _copy_kernel: one grid step per requested row, the block
// index map reading the row id from scalar prefetch so that each packed
// row arrives as one DMA) and ::unpacked_lookup (Pallas body
// _copy_reshape_kernel: one grid step, one DMA, per (request, item)).
//
// What bounds them on an H100: bytes.  A gather of `rows` rows moves the
// ids in, each table row they touch once, and the rows out.  At the
// replay's shapes (4-byte rows, a window's ids) that is a few megabytes;
// at (C 10,000, omega 5, d 256) float32 rows and R 65,536 it is the 51 MB
// table plus a 335 MB output, 0.116 ms at 3.35 TB/s, as long as the
// table's rows are read from device memory once and then from L2.
//
// Design: the dispatch (route()) picks one of five copy paths by row size,
// alignment and table size; none divides per copy unit.
//  * narrow (rows of 4, 8, 12 or 16 bytes, ids and output 16-byte
//    aligned): a thread takes four consecutive requests, brings their ids
//    with one 16-byte load, gathers the four rows word by word and writes
//    them with row_bytes / 4 16-byte stores; the last rows % 4 requests
//    take a lane each.
//  * wide (rows of a 16-byte multiple above 16 bytes, table and output
//    16-byte aligned) below one 6 MB slice a row: the table is read with
//    an L2 evict_last policy and the output written past it with
//    streaming stores, so that the stores do not push the table out of
//    the 50 MB L2.  A table of at most one 6 MB slice takes `vector`: a
//    warp a 2 KB piece of a row, 16-byte loads
//    (ld.global.L2::cache_hint) four a lane in flight, then streaming
//    stores (st.global.cs).  A larger one takes `sliced`: the table walked
//    in 6 MB slices by a grid resident at once (a warp takes 32 requests,
//    copies those in the slice), so that a row the ids repeat is read from
//    device memory about once even when the table does not fit L2.  A
//    warp copies whole rows while the requests give every warp of the grid
//    a group; when they are too few for that and the rows are long (above
//    64 KB), each row is cut into pieces of 2 KB multiples and a warp
//    takes a (group, piece) pair, so that a few rows still spread over the
//    whole grid.
//  * stream (rows of a 16-byte multiple of at least one 6 MB slice, the
//    same alignment; the expert gathers' 7.9 to 78.6 MB clique rows): such
//    a row cannot stay in L2 from one request to the next, so the gather
//    is one read of each requested row and one write, and the design is a
//    plain copy at the memory's rate.  Each row is cut into 48 KB pieces,
//    handed to the blocks of a grid resident at once (one block a SM)
//    round robin, so the grid walks the output front to back together and
//    two rows still keep every SM busy.  A block is a ring of 4 stages of
//    shared memory driven by one thread: a bulk copy (cp.async.bulk, the
//    tensor memory accelerator) brings a piece in, completing on the
//    stage's mbarrier, and a bulk copy writes it out; 4 pieces, 192 KB, in
//    flight a SM without a register or an instruction a 16-byte unit.  No
//    slice walk: `sliced` made every warp take one id load and one ballot
//    for each of the table's slices (69 at deepseek-v2's expert table, 18
//    of them requested), held 4 units a lane in flight, and read 1.4 GB
//    through the 50 MB L2 under evict_last (times on an NVIDIA H100 80GB
//    HBM3 at 700 W: PERF.md section 6).  In development runs on that card,
//    register copies (8 or 16 units a thread, shares a block or a warp,
//    grid-stride orders, evict-first or streaming loads) all ran slower
//    than this ring on deepseek-v2's gather, as did the ring with each
//    block taking one contiguous share or loading under an L2 evict_first
//    policy; rings of 16 to 96 KB stages traded the large gather against
//    the small ones.  The TPU's one DMA a row has its closest form here.
//  * ragged (any other size or alignment): a group of lanes a row, sized to
//    the row up to a warp, in the widest unit that divides the row size and
//    both buffers' alignment, with the same cache hints as wide.
// Every path moves bytes only, so each equals the plain PyTorch gather bit
// for bit.  The ids are NOT range-checked here: the caller checks them
// against [0, C) (on the host where they come from the host), since a
// gather outside the table would read other memory.
#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// blocks of a grid-stride launch, per SM
constexpr int kBlocksPerSm = 16;
// the wide vector design: 16-byte units a lane in flight; requests a warp
// takes at a time and the table bytes a slice of the sliced form
constexpr int kUnroll = 4;
constexpr int kGroup = 32;
// the stream design: bulk copies in flight a block, and their bytes (one
// block a SM: 192 KB of shared memory)
constexpr int kStages = 4;
constexpr int kStageBytes = 48 << 10;
constexpr long long kSliceBytes = 6LL << 20;
constexpr int kMaxDevices = 64;

// the copy paths, as lookup_rows_launch reports them
enum Path { kNarrow = 0, kVector = 1, kSliced = 2, kRagged = 3, kStream = 4 };

// ---- cache hints ----------------------------------------------------------

__device__ __forceinline__ std::uint64_t evict_last_policy() {
  std::uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// loads that keep the line in L2 (the table), stores that stream past it
// (the output), one overload per copy unit
__device__ __forceinline__ uint4 ld_keep(const uint4* p, std::uint64_t pol) {
  uint4 v;
  asm volatile(
      "ld.global.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3},"
      " [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ uint2 ld_keep(const uint2* p, std::uint64_t pol) {
  uint2 v;
  asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned ld_keep(const unsigned* p,
                                            std::uint64_t pol) {
  unsigned v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(v)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned short ld_keep(const unsigned short* p,
                                                  std::uint64_t pol) {
  unsigned short v;
  asm volatile("ld.global.L2::cache_hint.u16 %0, [%1], %2;"
               : "=h"(v)
               : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned char ld_keep(const unsigned char* p,
                                                 std::uint64_t pol) {
  unsigned short v;
  asm volatile("ld.global.L2::cache_hint.u8 %0, [%1], %2;"
               : "=h"(v)
               : "l"(p), "l"(pol));
  return static_cast<unsigned char>(v);
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void st_stream(uint2* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y)
               : "memory");
}
__device__ __forceinline__ void st_stream(unsigned* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_stream(unsigned short* p,
                                          unsigned short v) {
  asm volatile("st.global.cs.u16 [%0], %1;" :: "l"(p), "h"(v) : "memory");
}
__device__ __forceinline__ void st_stream(unsigned char* p, unsigned char v) {
  const unsigned short w = v;
  asm volatile("st.global.cs.u8 [%0], %1;" :: "l"(p), "h"(w) : "memory");
}

// ---- narrow rows: four requests a thread ----------------------------------

// W 32-bit words a row (row_bytes 4 W); ids and out 16-byte aligned
template <int W>
__global__ void __launch_bounds__(kThreads)
gather_narrow(const unsigned* __restrict__ table, const int* __restrict__ ids,
              unsigned* __restrict__ out, long long rows) {
  const long long quads = rows >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       q < quads; q += stride) {
    const int4 id = __ldg(ids4 + q);
    const int r[4] = {id.x, id.y, id.z, id.w};
    unsigned v[4 * W];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        v[i * W + w] = __ldg(table + static_cast<long long>(r[i]) * W + w);
      }
    }
#pragma unroll
    for (int s = 0; s < W; ++s) {
      out4[q * W + s] =
          make_uint4(v[4 * s], v[4 * s + 1], v[4 * s + 2], v[4 * s + 3]);
    }
  }
  // the ragged tail: rows % 4 requests, a lane each
  const long long r = (quads << 2) + threadIdx.x;
  if (blockIdx.x == 0 && r < rows) {
    const long long src = static_cast<long long>(ids[r]) * W;
#pragma unroll
    for (int w = 0; w < W; ++w) out[r * W + w] = __ldg(table + src + w);
  }
}

// ---- wide rows, vector design ---------------------------------------------

// units [base, end) of a row by the 32 lanes of a warp, kUnroll loads a
// lane in flight at a time
__device__ __forceinline__ void copy_units(const uint4* __restrict__ src,
                                           uint4* __restrict__ dst,
                                           int base, int end, int lane,
                                           std::uint64_t keep) {
  for (; base < end; base += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * 32 + lane;
      if (c < end) v[u] = ld_keep(src + c, keep);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * 32 + lane;
      if (c < end) st_stream(dst + c, v[u]);
    }
  }
}

// a warp a piece of a row: the row's first 32 kUnroll units, or its next,
// so that a few long rows still spread over many warps
__global__ void __launch_bounds__(kThreads)
gather_wide_vector(const uint4* __restrict__ table,
                   const int* __restrict__ ids, uint4* __restrict__ out,
                   int row_units, int pieces, long long rows) {
  constexpr int kPiece = 32 * kUnroll;
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const std::uint64_t keep = evict_last_policy();
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> 5;
       i < rows * pieces; i += nwarps) {
    const long long r = i / pieces;
    const int base = static_cast<int>(i - r * pieces) * kPiece;
    const int end = base + kPiece < row_units ? base + kPiece : row_units;
    copy_units(table + static_cast<long long>(__ldg(ids + r)) * row_units,
               out + r * row_units, base, end, lane, keep);
  }
}

// The table in slices of slice_rows rows that fit L2 with room to spare:
// every warp copies the requests of slice 0, then of slice 1, ..., so the
// resident grid reads one slice at a time and each touched row comes from
// device memory about once, however many requests repeat it.  A warp
// takes kGroup consecutive requests and one piece of their rows at a time
// (a work item): their ids in one load, a ballot of those in the slice,
// then one copy of the piece each.  With pieces == 1 a piece is the whole
// row.  Unit offsets past 2^31 stay in 64-bit pointers: a piece's own
// count fits an int (a row is below one slice: route()).
__global__ void __launch_bounds__(kThreads)
gather_wide_sliced(const uint4* __restrict__ table,
                   const int* __restrict__ ids, uint4* __restrict__ out,
                   long long row_units, long long rows, long long slice_rows,
                   long long slices, long long pieces,
                   long long piece_units) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) >> 5;
  const long long nwarps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long work = (rows + kGroup - 1) / kGroup * pieces;
  const std::uint64_t keep = evict_last_policy();
  for (long long s = 0; s < slices; ++s) {
    const long long lo = s * slice_rows;
    const long long hi = lo + slice_rows;
    for (long long i = warp; i < work; i += nwarps) {
      const long long g = pieces == 1 ? i : i / pieces;
      const long long u0 = (i - g * pieces) * piece_units;
      const int count = static_cast<int>(
          u0 + piece_units < row_units ? piece_units : row_units - u0);
      const long long base = g * kGroup;
      const long long r = base + lane;
      const int id = (lane < kGroup && r < rows) ? __ldg(ids + r) : -1;
      unsigned hit = __ballot_sync(0xffffffffu, id >= lo && id < hi);
      while (hit) {
        const int j = __ffs(hit) - 1;
        hit &= hit - 1;
        const int src = __shfl_sync(0xffffffffu, id, j);
        copy_units(table + static_cast<long long>(src) * row_units + u0,
                   out + (base + j) * row_units + u0, 0, count, lane, keep);
      }
    }
  }
}

// ---- rows of a slice or more: a ring of bulk copies -----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one stage of the ring: its mbarrier counts the bytes of its bulk load
__device__ __forceinline__ void stage_load(unsigned dst, const void* src,
                                           unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void stage_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void stage_store(void* dst, unsigned src,
                                            unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Each row cut into pieces of kStageBytes (the last one shorter, a 16-byte
// multiple); piece j of the rows' pieces goes to block j mod gridDim.x, so
// that the grid walks the output front to back together.  One thread a
// block keeps kStages bulk loads (global -> shared, completing on the
// stage's mbarrier) in flight and writes each piece back with a bulk store
// (shared -> global) as it lands; a stage is loaded again once the store
// that read it is done (wait_group.read).
__global__ void __launch_bounds__(32)
gather_rows_stream(const char* __restrict__ table,
                   const int* __restrict__ ids, char* __restrict__ out,
                   long long row_bytes, long long rows) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bars[kStages];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(&bars[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const long long pieces = (row_bytes + kStageBytes - 1) / kStageBytes;
  const long long count = rows * pieces;
  long long next = blockIdx.x;                    // the next piece to load
  long long dst[kStages];                         // each stage's output offset
  unsigned bytes[kStages];
  auto load = [&](int s) {
    const long long r = next / pieces;
    const long long off = (next - r * pieces) * kStageBytes;
    const long long left = row_bytes - off;
    dst[s] = r * row_bytes + off;
    bytes[s] = static_cast<unsigned>(left < kStageBytes ? left : kStageBytes);
    stage_load(smem_addr(ring + s * kStageBytes),
               table + static_cast<long long>(ids[r]) * row_bytes + off,
               bytes[s], smem_addr(&bars[s]));
    next += gridDim.x;
  };
  int loaded = 0;
  for (; loaded < kStages && next < count; ++loaded) load(loaded);
  for (int d = 0; d < loaded; ++d) {
    const int s = d % kStages;
    stage_wait(smem_addr(&bars[s]), (d / kStages) & 1);
    stage_store(out + dst[s], smem_addr(ring + s * kStageBytes), bytes[s]);
    // refill the stage whose store went out one piece ago
    if (d >= 1 && next < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load((d - 1) % kStages);
      ++loaded;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- ragged rows: a group of lanes a row -----------------------------------

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_ragged(const U* __restrict__ table, const int* __restrict__ ids,
              U* __restrict__ out, long long row_units, long long rows,
              int shift) {
  const int group = 1 << shift;
  const int lane = threadIdx.x & (group - 1);
  const long long per_pass = (static_cast<long long>(gridDim.x) * kThreads)
                             >> shift;
  const std::uint64_t keep = evict_last_policy();
  for (long long r = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) >> shift;
       r < rows; r += per_pass) {
    const U* src = table + static_cast<long long>(__ldg(ids + r)) * row_units;
    U* dst = out + r * row_units;
    for (long long c = lane; c < row_units; c += group) {
      st_stream(dst + c, ld_keep(src + c, keep));
    }
  }
}

// ---- dispatch ---------------------------------------------------------------

// what a launch needs to know of the current device, looked up once a device
struct Device {
  int sms = 0;            // streaming multiprocessors
  int sliced_per_sm = 0;  // gather_wide_sliced blocks resident on one
  int stream_per_sm = 0;  // gather_rows_stream blocks resident on one
};

cudaError_t current_device(Device** info) {
  static Device devices[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (d.sms == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.sliced_per_sm, gather_wide_sliced, kThreads, 0);
    if (e != cudaSuccess) return e;
    constexpr int kRing = kStages * kStageBytes;
    e = cudaFuncSetAttribute(gather_rows_stream,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRing);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.stream_per_sm, gather_rows_stream, 32, kRing);
    if (e != cudaSuccess) return e;
    d.sms = sms;
  }
  *info = &d;
  return cudaSuccess;
}

int blocks_for(const Device& dev, long long work, long long per_block) {
  const long long most = static_cast<long long>(dev.sms) * kBlocksPerSm;
  const long long want = (work + per_block - 1) / per_block;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

Path route(const void* table, long long table_rows, const int* ids,
           const void* out, long long row_bytes) {
  if (row_bytes <= 16 && row_bytes % 4 == 0 && aligned(table, 4) &&
      aligned(ids, 16) && aligned(out, 16)) {
    return kNarrow;
  }
  if (row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16)) {
    if (row_bytes >= kSliceBytes) return kStream;
    return table_rows * row_bytes > kSliceBytes ? kSliced : kVector;
  }
  return kRagged;
}

template <typename U>
int launch_ragged(const Device& dev, const void* table, const int* ids,
                  void* out, long long rows, long long row_bytes,
                  cudaStream_t stream) {
  const long long row_units = row_bytes / static_cast<long long>(sizeof(U));
  int shift = 0;
  while (shift < 5 && (1LL << shift) < row_units) ++shift;
  gather_ragged<U><<<blocks_for(dev, rows, kThreads >> shift), kThreads, 0,
                     stream>>>(
      static_cast<const U*>(table), ids, static_cast<U*>(out), row_units,
      rows, shift);
  return static_cast<int>(cudaGetLastError());
}

// the sliced vector form on a grid that is resident at once, so that all
// warps walk the slices together; rows (below one slice: route()) cut into
// pieces when the request groups leave warps idle and a row is long
int launch_sliced(const Device& dev, const void* table, long long table_rows,
                  const int* ids, void* out, long long rows,
                  long long row_bytes, cudaStream_t stream) {
  constexpr long long kPieceUnits = 32 * kUnroll;   // 2 KB
  constexpr long long kSplitUnits = 4096;           // rows above 64 KB
  long long slice_rows = kSliceBytes / row_bytes;
  if (slice_rows > table_rows) slice_rows = table_rows;
  const long long slices = (table_rows + slice_rows - 1) / slice_rows;
  const long long row_units = row_bytes / 16;
  const long long most = static_cast<long long>(dev.sms) * dev.sliced_per_sm;
  const long long warps = most * (kThreads / 32);
  const long long groups = (rows + kGroup - 1) / kGroup;
  long long pieces = 1;
  if (row_units > kSplitUnits && groups < warps) {
    const long long want = (warps + groups - 1) / groups;
    const long long most_pieces = (row_units + kPieceUnits - 1) / kPieceUnits;
    pieces = want < most_pieces ? want : most_pieces;
  }
  long long piece_units = (row_units + pieces - 1) / pieces;
  if (pieces > 1 || piece_units < row_units) {
    piece_units = (piece_units + kPieceUnits - 1) / kPieceUnits * kPieceUnits;
    pieces = (row_units + piece_units - 1) / piece_units;
  }
  const long long items = groups * pieces;
  const long long want = (items + kThreads / 32 - 1) / (kThreads / 32);
  const int blocks = static_cast<int>(want < most ? want : most);
  gather_wide_sliced<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(table), ids, static_cast<uint4*>(out),
      row_units, rows, slice_rows, slices, pieces, piece_units);
  return static_cast<int>(cudaGetLastError());
}

// the stream form on a grid that is resident at once (one block a SM), at
// most one block a piece
int launch_stream(const Device& dev, const void* table, const int* ids,
                  void* out, long long rows, long long row_bytes,
                  cudaStream_t stream) {
  const long long pieces = (row_bytes + kStageBytes - 1) / kStageBytes;
  const long long most = static_cast<long long>(dev.sms) * dev.stream_per_sm;
  const long long blocks = rows * pieces < most ? rows * pieces : most;
  gather_rows_stream<<<static_cast<int>(blocks), 32, kStages * kStageBytes,
                       stream>>>(static_cast<const char*>(table), ids,
                                 static_cast<char*>(out), row_bytes, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (table_rows, row_bytes) of any element type, ids (rows,) int32 in
// [0, table_rows), out (rows, row_bytes).  Writes the copy path it takes
// to *path (0 narrow, 1 vector, 2 sliced, 3 ragged, 4 stream; -1 when
// there is nothing to copy) and returns the launch's CUDA error code.
extern "C" int lookup_rows_launch(const void* table, long long table_rows,
                                  const int* ids, void* out, long long rows,
                                  long long row_bytes, int* path,
                                  cudaStream_t stream) {
  *path = -1;
  if (rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  Device* dev = nullptr;
  const cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Path p = route(table, table_rows, ids, out, row_bytes);
  *path = p;
  switch (p) {
    case kNarrow: {
      const auto* t = static_cast<const unsigned*>(table);
      auto* o = static_cast<unsigned*>(out);
      const int blocks = blocks_for(*dev, rows >> 2, kThreads);
      switch (row_bytes / 4) {
        case 1: gather_narrow<1><<<blocks, kThreads, 0, stream>>>(t, ids, o, rows); break;
        case 2: gather_narrow<2><<<blocks, kThreads, 0, stream>>>(t, ids, o, rows); break;
        case 3: gather_narrow<3><<<blocks, kThreads, 0, stream>>>(t, ids, o, rows); break;
        default: gather_narrow<4><<<blocks, kThreads, 0, stream>>>(t, ids, o, rows); break;
      }
      return static_cast<int>(cudaGetLastError());
    }
    case kStream:
      return launch_stream(*dev, table, ids, out, rows, row_bytes, stream);
    case kSliced:
      return launch_sliced(*dev, table, table_rows, ids, out, rows, row_bytes,
                           stream);
    case kVector: {
      const int row_units = static_cast<int>(row_bytes / 16);
      const int pieces = (row_units + 32 * kUnroll - 1) / (32 * kUnroll);
      gather_wide_vector<<<blocks_for(*dev, rows * pieces, kThreads / 32),
                           kThreads, 0, stream>>>(
          static_cast<const uint4*>(table), ids, static_cast<uint4*>(out),
          row_units, pieces, rows);
      return static_cast<int>(cudaGetLastError());
    }
    default: {
      const auto a = reinterpret_cast<std::uintptr_t>(table) |
                     reinterpret_cast<std::uintptr_t>(out) |
                     static_cast<std::uintptr_t>(row_bytes);
      if (a % 16 == 0) return launch_ragged<uint4>(*dev, table, ids, out, rows, row_bytes, stream);
      if (a % 8 == 0) return launch_ragged<uint2>(*dev, table, ids, out, rows, row_bytes, stream);
      if (a % 4 == 0) return launch_ragged<unsigned>(*dev, table, ids, out, rows, row_bytes, stream);
      if (a % 2 == 0) return launch_ragged<unsigned short>(*dev, table, ids, out, rows, row_bytes, stream);
      return launch_ragged<unsigned char>(*dev, table, ids, out, rows, row_bytes, stream);
    }
  }
}

REPRO_EXPORT_ERROR_STRING(packed_lookup)
