// Initial density matrix D of the approximate merge (paper Alg. 3):
//
//   within[i] = X[i, i] / 2
//   e(i u j)  = (within[i] + within[j]) + X[i, j]
//   D[i, j]   = e / e_max   if |i| + |j| == omega and i != j, else -1
//   D[i, j]   = -1          where that density is below gamma
//
// Replaces the TPU kernel repro/kernels/merge_step.py::merge_density
// (Pallas body _merge_density_kernel), one row block of D per grid step on
// the VPU.
//
// What bounds it on an H100: bytes.  A handful of operations per element
// against 8 bytes moved per element (read X, write D) plus the (S,) sizes;
// 32 MB at S = 2048, about 10 us at 3.35 TB/s.
//
// Design: one thread per element of D, neighbouring threads on neighbouring
// columns so reads of X and writes of D are coalesced; the two diagonal
// reads hit the same few cache lines for a whole row.  The float32 operation
// order is that of merge_density_jnp / core.cliques._densities, with every
// add and divide written as an explicit round-to-nearest intrinsic so no
// contraction or approximate division can change a bit: the result equals
// the plain PyTorch version bit for bit.  e_max is computed in float64 by
// the caller and rounded once to float32, as the reference does.
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_density_kernel(const float* __restrict__ X, const int* __restrict__ sizes,
                     float* __restrict__ D, int S, int omega, float gamma,
                     float e_max) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(S) * S) return;
  const int i = static_cast<int>(idx / S);
  const int j = static_cast<int>(idx - static_cast<size_t>(i) * S);
  const float wi = __fdiv_rn(X[static_cast<size_t>(i) * S + i], 2.0f);
  const float wj = __fdiv_rn(X[static_cast<size_t>(j) * S + j], 2.0f);
  const float e_u = __fadd_rn(__fadd_rn(wi, wj), X[idx]);
  const bool ok = (sizes[i] + sizes[j] == omega) && (i != j);
  const float dens = ok ? __fdiv_rn(e_u, e_max) : -1.0f;
  D[idx] = (dens >= gamma) ? dens : -1.0f;
}

}  // namespace

// X: (S, S) float32, sizes: (S,) int32, D: (S, S) float32, all contiguous.
extern "C" int merge_density_launch(const float* X, const int* sizes, float* D,
                                    int S, int omega, float gamma, float e_max,
                                    cudaStream_t stream) {
  const size_t total = static_cast<size_t>(S) * S;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  merge_density_kernel<<<blocks, kThreads, 0, stream>>>(X, sizes, D, S, omega,
                                                        gamma, e_max);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(merge_density)
