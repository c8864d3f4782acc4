// Packed-clique gather: out[r] = table[ids[r]] for whole (omega, d) rows.
// The replay uses it once a request batch as the item -> clique-id lookup
// (table = clique_of reshaped to (n, 1, 1) int32).
//
// Replaces the TPU kernel repro/kernels/packed_lookup.py::packed_lookup
// (Pallas body _copy_kernel): one grid step per requested row, the block
// index map reading the row id from scalar prefetch so that each packed
// row arrives as one DMA.
//
// What bounds it on an H100: bytes.  It moves R row ids in and R rows out
// and reads R rows of the table: 4 R + 2 R row_bytes.  At the replay's
// shapes (a few thousand 4-byte rows) that is tens of kilobytes, and the
// launch sets the time; at (C 4096, omega 5, d 128) float32 rows it is
// memory traffic.
//
// Design: a grid-stride loop over the output in the widest unit that
// divides the row size and the alignment of both buffers (16, 8, 4, 2 or 1
// bytes), so rows of 16-byte multiples move as 16-byte vectors and
// neighbouring threads touch neighbouring addresses of one row.  The copy
// moves bytes, so the result equals the plain PyTorch gather bit for bit.
// The ids are NOT range-checked here: the caller checks them against
// [0, C) (on the host where they come from the host), since a gather
// outside the table would read other memory.
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

}  // namespace

// table (C, row_bytes) of any element type, ids (R,) int32 in [0, C),
// out (R, row_bytes)
extern "C" int packed_lookup_launch(const void* table, const int* ids,
                                    void* out, int R, long long row_bytes,
                                    cudaStream_t stream) {
  if (R <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  const auto align = reinterpret_cast<std::uintptr_t>(table) |
                     reinterpret_cast<std::uintptr_t>(out) |
                     static_cast<std::uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(table, ids, out, R, row_bytes, stream);
  if (align % 8 == 0) return launch<uint2>(table, ids, out, R, row_bytes, stream);
  if (align % 4 == 0) return launch<unsigned int>(table, ids, out, R, row_bytes, stream);
  if (align % 2 == 0) return launch<unsigned short>(table, ids, out, R, row_bytes, stream);
  return launch<unsigned char>(table, ids, out, R, row_bytes, stream);
}

REPRO_EXPORT_ERROR_STRING(packed_lookup)
