// All-pairs clique union edge counts X = M A M^T (paper Alg. 3 merge scan):
// M the (S, h) 0/1 clique membership over the hot slots, A the (h, h) 0/1
// binary CRM.  Off the diagonal X[i, j] counts cross edges between groups i
// and j; on it, X[i, i] is twice the within-group count.
//
// Replaces the TPU kernel repro/kernels/clique_density.py::clique_pair_edges
// (Pallas body _density_kernel): one grid step per row block of M, with
// the row strip T = M_i A held in VMEM scratch between the two products.
//
// What bounds it on an H100: operations.  2 S h^2 + 2 S^2 h flops (13
// GFLOP at S = 2h = 2048) against (S h + h^2 + S^2) * 4 bytes (~29 MB),
// several hundred flops a byte; it runs on the fp32 FMA units (67 TFLOP/s
// peak), not the tensor cores.
//
// Design: one 256-thread block per strip of 8 rows of M, as the TPU kernel
// keeps its strip on chip.  The strip of M and T = M_strip A (8 x h fp32
// each, 32 KB apiece at h = 1024) live in dynamic shared memory; T is never
// written to device memory.  Phase 1 gives each thread whole columns k of
// T and streams rows of A with coalesced loads, reusing each A element for
// all 8 rows.  Phase 2 computes X[strip, c] = T M[c]^T for 256 columns c
// at a time, staging a 16-deep slice of those rows of M transposed in
// shared memory (padded to avoid bank conflicts) so that device-memory
// reads stay coalesced.  T holds integers up to h and X integers below
// 2^24 (the caller checks h(h-1)/2 < 2^24), so fp32 is exact in any order
// and the result equals the plain PyTorch M @ A @ M^T bit for bit.  T must
// stay fp32: bf16 is exact only up to 256.
#include "launch.cuh"

namespace {

constexpr int kRows = 8;       // rows of M per block (the strip)
constexpr int kThreads = 256;
constexpr int kDepth = 16;     // depth of the staged M^T slice
constexpr int kPitch = kThreads + 1;

__global__ void __launch_bounds__(kThreads)
density_kernel(const float* __restrict__ M, const float* __restrict__ A,
               float* __restrict__ X, int S, int h) {
  extern __shared__ float smem[];
  float* Ms = smem;                 // (kRows, h) strip of M
  float* T = Ms + kRows * h;        // (kRows, h) T = M_strip A
  float* Mt = T + kRows * h;        // (kDepth, kPitch) slice of M^T
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;

  for (int e = tid; e < kRows * h; e += kThreads) {
    const int r = e / h;
    const int l = e - r * h;
    Ms[e] = (r0 + r < S) ? M[static_cast<size_t>(r0 + r) * h + l] : 0.0f;
  }
  __syncthreads();

  // phase 1: T[r, k] = sum_l Ms[r, l] * A[l, k]
  for (int k = tid; k < h; k += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int l = 0; l < h; ++l) {
      const float a = A[static_cast<size_t>(l) * h + k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(Ms[r * h + l], a, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) T[r * h + k] = acc[r];
  }
  __syncthreads();

  // phase 2: X[r0 + r, c] = sum_k T[r, k] * M[c, k]
  for (int c0 = 0; c0 < S; c0 += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k0 = 0; k0 < h; k0 += kDepth) {
      for (int e = tid; e < kDepth * kThreads; e += kThreads) {
        const int cc = e / kDepth;
        const int kk = e - cc * kDepth;
        const int c = c0 + cc;
        const int k = k0 + kk;
        Mt[kk * kPitch + cc] =
            (c < S && k < h) ? M[static_cast<size_t>(c) * h + k] : 0.0f;
      }
      __syncthreads();
      const int kn = min(kDepth, h - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float mv = Mt[kk * kPitch + tid];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(T[r * h + k0 + kk], mv, acc[r]);
      }
      __syncthreads();
    }
    const int c = c0 + tid;
    if (c < S) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < S) X[static_cast<size_t>(r0 + r) * S + c] = acc[r];
    }
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for a hot space of h slots.
extern "C" size_t clique_pair_edges_smem_bytes(int h) {
  return (static_cast<size_t>(2) * kRows * h + kDepth * kPitch) * sizeof(float);
}

// M: (S, h) float32, A: (h, h) float32, X: (S, S) float32, all contiguous.
extern "C" int clique_pair_edges_launch(const float* M, const float* A,
                                        float* X, int S, int h,
                                        cudaStream_t stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = clique_pair_edges_smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(
      density_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kRows - 1) / kRows;
  density_kernel<<<blocks, kThreads, smem, stream>>>(M, A, X, S, h);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(clique_pair_edges)
