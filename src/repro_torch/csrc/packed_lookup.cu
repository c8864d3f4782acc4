// Packed-clique gather, out[r] = table[ids[r]] for whole (omega, d) rows,
// and its unpacked baseline, out[r, o] = items[ids[r, o]] for d-wide rows.
// The replay uses the packed gather once a request batch as the item ->
// clique-id lookup (table = clique_of reshaped to (n, 1, 1) int32); the
// kernel benchmark sets the two against each other.
//
// Replaces the TPU kernels repro/kernels/packed_lookup.py::packed_lookup
// (Pallas body _copy_kernel: one grid step per requested row, the block
// index map reading the row id from scalar prefetch so that each packed
// row arrives as one DMA) and ::unpacked_lookup (Pallas body
// _copy_reshape_kernel: one grid step, one DMA, per (request, item)).
//
// What bounds them on an H100: bytes.  The packed gather moves R row ids in
// and R rows out and reads R rows of the table: 4 R + 2 R row_bytes; the
// unpacked one 4 R omega + 2 R omega d elements.  At the replay's shapes (a
// few thousand 4-byte rows) that is tens of kilobytes, and the launch sets
// the time; at (C 10,000, omega 5, d 256) float32 rows and R 65,536 it is
// 670 MB of traffic, about 0.2 ms at 3.35 TB/s.
//
// Design.  Both copy in the widest unit that divides the row size and the
// alignment of both buffers (16, 8, 4, 2 or 1 bytes), so rows of 16-byte
// multiples move as 16-byte vectors.  packed_lookup: a grid-stride loop over
// the output's units, neighbouring threads on neighbouring addresses of one
// row.  unpacked_lookup: one copy unit per (request, item): a group of
// threads (a power of two, up to a block, sized to the row) takes one
// d-wide row, reads its id once and copies the row with copy_row; the
// block's groups take consecutive (request, item) rows.  That keeps the
// reference's granularity (R omega row copies against the packed gather's R
// block copies) without leaving 31 lanes of a warp idle on a short row.
// Both move bytes only, so each equals the plain PyTorch gather bit for bit.
// The ids are NOT range-checked here: the caller checks them against
// [0, C) or [0, n) (on the host where they come from the host), since a
// gather outside the table would read other memory.
#include "launch.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows(const U* __restrict__ table, const int* __restrict__ ids,
            U* __restrict__ out, long long row_units, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const long long r = e / row_units;
    const long long c = e - r * row_units;
    out[e] = table[static_cast<long long>(ids[r]) * row_units + c];
  }
}

// one row of `units` elements, copied by the `group` threads whose rank in
// the group is `lane`: neighbouring lanes on neighbouring addresses
template <typename U>
__device__ __forceinline__ void copy_row(const U* __restrict__ src,
                                         U* __restrict__ dst, long long units,
                                         int lane, int group) {
  for (long long c = lane; c < units; c += group) dst[c] = src[c];
}

// rows = R * omega copy units; group threads (a power of two <= kThreads)
// per unit
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_items(const U* __restrict__ items, const int* __restrict__ ids,
             U* __restrict__ out, long long row_units, long long rows,
             int group) {
  const int lane = threadIdx.x & (group - 1);
  const long long per_pass =
      static_cast<long long>(gridDim.x) * (kThreads / group);
  for (long long row = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) / group;
       row < rows; row += per_pass) {
    copy_row(items + static_cast<long long>(ids[row]) * row_units,
             out + row * row_units, row_units, lane, group);
  }
}

template <typename U>
int launch(const void* table, const int* ids, void* out, int R,
           long long row_bytes, cudaStream_t stream) {
  const long long row_units = row_bytes / static_cast<long long>(sizeof(U));
  const long long total = row_units * R;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  gather_rows<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(table), ids, static_cast<U*>(out), row_units,
      total);
  return static_cast<int>(cudaGetLastError());
}

template <typename U>
int launch_items(const void* items, const int* ids, void* out, long long rows,
                 long long row_bytes, cudaStream_t stream) {
  const long long row_units = row_bytes / static_cast<long long>(sizeof(U));
  int group = 1;
  while (group < kThreads && group < row_units) group <<= 1;
  const long long per_block = kThreads / group;
  const long long want = (rows + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  gather_items<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(items), ids, static_cast<U*>(out), row_units,
      rows, group);
  return static_cast<int>(cudaGetLastError());
}

// the widest copy unit that divides the row size and both buffers' alignment
int unit_bytes(const void* src, const void* dst, long long row_bytes) {
  const auto align = reinterpret_cast<std::uintptr_t>(src) |
                     reinterpret_cast<std::uintptr_t>(dst) |
                     static_cast<std::uintptr_t>(row_bytes);
  for (int u = 16; u > 1; u >>= 1) {
    if (align % u == 0) return u;
  }
  return 1;
}

}  // namespace

// table (C, row_bytes) of any element type, ids (R,) int32 in [0, C),
// out (R, row_bytes)
extern "C" int packed_lookup_launch(const void* table, const int* ids,
                                    void* out, int R, long long row_bytes,
                                    cudaStream_t stream) {
  if (R <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  switch (unit_bytes(table, out, row_bytes)) {
    case 16: return launch<uint4>(table, ids, out, R, row_bytes, stream);
    case 8: return launch<uint2>(table, ids, out, R, row_bytes, stream);
    case 4: return launch<unsigned int>(table, ids, out, R, row_bytes, stream);
    case 2: return launch<unsigned short>(table, ids, out, R, row_bytes, stream);
    default: return launch<unsigned char>(table, ids, out, R, row_bytes, stream);
  }
}

// items (n, row_bytes) of any element type, ids (R, omega) int32 in [0, n)
// flattened to rows = R * omega, out (R, omega, row_bytes)
extern "C" int unpacked_lookup_launch(const void* items, const int* ids,
                                      void* out, long long rows,
                                      long long row_bytes,
                                      cudaStream_t stream) {
  if (rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  switch (unit_bytes(items, out, row_bytes)) {
    case 16: return launch_items<uint4>(items, ids, out, rows, row_bytes, stream);
    case 8: return launch_items<uint2>(items, ids, out, rows, row_bytes, stream);
    case 4: return launch_items<unsigned int>(items, ids, out, rows, row_bytes, stream);
    case 2: return launch_items<unsigned short>(items, ids, out, rows, row_bytes, stream);
    default: return launch_items<unsigned char>(items, ids, out, rows, row_bytes, stream);
  }
}

REPRO_EXPORT_ERROR_STRING(packed_lookup)
