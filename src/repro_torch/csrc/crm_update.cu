// Window co-occurrence counts of the CRM (paper Alg. 2): out = H^T H with a
// zero diagonal, H the (rows, h) 0/1 request x hot-item incidence.
//
// Replaces the TPU kernel repro/kernels/crm_update.py::crm_update (Pallas
// body _crm_kernel): a transpose-matmul tiled over (h/bm, h/bn) output
// blocks with the request axis as a sequential grid dimension accumulating
// in VMEM.  Here blocks run in parallel and carry nothing between them, so
// each block loops over one chunk of the request axis and the chunks meet
// in the output through atomic adds.
//
// What bounds it on an H100: operations.  2 * rows * h^2 flops against
// rows * h * 4 bytes read, about h/2 flops a byte (~512 at h = 1024), far
// above the card's fp32 balance point; the kernel runs on the fp32 FMA
// units (67 TFLOP/s peak), not the tensor cores.
//
// Design: a plain shared-memory tiled GEMM, split along the rows.  Each
// 256-thread block owns a 64 x 64 output tile and one chunk of rows, which
// it walks in stages of 16: both 16 x 64 column strips of H go to shared
// memory with coalesced loads (neighbouring threads read neighbouring
// columns of one row), then every thread accumulates a 4 x 4 register
// sub-tile, and adds it to the zeroed output with atomicAdd.  The chunk
// count is chosen so that at least two blocks per SM are in flight even
// when h is small (at h = 32 there is a single output tile).  H holds 0/1
// and every partial sum is an integer below 2^24 (rows < 2^24 is checked
// by the caller), so fp32 accumulation, atomics included, is exact in any
// order and the result equals the plain PyTorch product bit for bit.  The
// diagonal receives no adds and stays zero.  The row stride ``ld`` lets the
// caller pass the leading h columns of a wider (rows, h + 1) buffer without
// a copy.
// Later work: build the tiles straight from the (rows, d) slot buffer, and
// use int8/fp8 wgmma (exact for 0/1 operands) instead of fp32 FMA.
#include "launch.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kStage = 16;    // rows of H per shared-memory stage
constexpr int kEdge = 16;     // threads along a tile edge (16 x 16 = 256)
constexpr int kThreads = kEdge * kEdge;
constexpr int kSub = kTile / kEdge;  // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
crm_kernel(const float* __restrict__ H, float* __restrict__ out, int rows,
           int h, int ld, int chunk) {
  __shared__ float As[kStage][kTile];
  __shared__ float Bs[kStage][kTile];
  const int tx = threadIdx.x % kEdge;
  const int ty = threadIdx.x / kEdge;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float acc[kSub][kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) acc[a][b] = 0.0f;

  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(rows, r_begin + chunk);
  for (int r0 = r_begin; r0 < r_end; r0 += kStage) {
    for (int e = threadIdx.x; e < kStage * kTile; e += kThreads) {
      const int kk = e / kTile;
      const int c = e % kTile;
      const int r = r0 + kk;
      const bool row_ok = r < r_end;
      const float* hrow = H + static_cast<size_t>(r) * ld;
      As[kk][c] = (row_ok && i0 + c < h) ? hrow[i0 + c] : 0.0f;
      Bs[kk][c] = (row_ok && j0 + c < h) ? hrow[j0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStage; ++kk) {
      float a[kSub], b[kSub];
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        a[s] = As[kk][ty + kEdge * s];
        b[s] = Bs[kk][tx + kEdge * s];
      }
#pragma unroll
      for (int p = 0; p < kSub; ++p)
#pragma unroll
        for (int q = 0; q < kSub; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kSub; ++p) {
    const int i = i0 + ty + kEdge * p;
    if (i >= h) continue;
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const int j = j0 + tx + kEdge * q;
      if (j < h && i != j && acc[p][q] != 0.0f)
        atomicAdd(out + static_cast<size_t>(i) * h + j, acc[p][q]);
    }
  }
}

}  // namespace

// H: (rows, ld) float32 with the first h columns used; out: (h, h) float32,
// zeroed by the caller.
extern "C" int crm_update_launch(const float* H, float* out, int rows, int h,
                                 int ld, cudaStream_t stream) {
  if (h <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kMinBlocks = 264;   // two per SM on an H100
  constexpr int kMinChunk = 256;    // rows a block walks at least
  const int tiles_1d = (h + kTile - 1) / kTile;
  const int tiles = tiles_1d * tiles_1d;
  int chunks = (kMinBlocks + tiles - 1) / tiles;
  chunks = max(1, min(chunks, (rows + kMinChunk - 1) / kMinChunk));
  int chunk = (rows + chunks - 1) / chunks;
  chunk = (chunk + kStage - 1) / kStage * kStage;
  chunks = (rows + chunk - 1) / chunk;
  const dim3 grid(tiles_1d, tiles_1d, chunks);
  crm_kernel<<<grid, kThreads, 0, stream>>>(H, out, rows, h, ld, chunk);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(crm_update)
