// All-pairs clique union edge counts X = M A M^T (paper Alg. 3 merge scan):
// M the (S, h) 0/1 clique membership over the hot slots, A the (h, h) 0/1
// binary CRM.  Off the diagonal X[i, j] counts cross edges between groups i
// and j; on it, X[i, i] is twice the within-group count.  A laned call
// takes S sweep lanes' (M, A) pairs in one launch of each pass, the lane
// on the grid's y.
//
// Replaces the TPU kernel repro/kernels/clique_density.py::clique_pair_edges
// (Pallas body _density_kernel): one grid step per row block of M, with
// the row strip T = M_i A held in VMEM scratch between the two products.
//
// What bounds it on an H100: bytes.  The replay's M has at most one 1 a
// column (a slot is in one group: core/cgm.py's M[hs, arange(h)] = 1, the
// host CGM's hot_membership of a partition), so with L_i the nonzero
// columns of row i, X[i, j] = sum over l in L_i, k in L_j of A[l, k] takes
// nnz(M) h + S nnz(M) adds: about 3 M at catalog-10k (S 2048, h 1024)
// against 21 MB to move (M and A read, the 16.8 MB X written).  Two dense
// products' 2 S h^2 + 2 S^2 h multiply-adds are nearly all of zeros.
//
// Design: segment sums, not two GEMMs, in two launches.
// 1. list_kernel, a warp a row of M: a ballot per 32 columns gives row j's
//    nonzero columns, written as a transposed ELL list (entry t
//    of row j at t * S + j, with the row's count), so that threads taking
//    consecutive rows j read consecutive addresses.  The capacity is h a
//    row, so no count has to reach the host first.
// 2. pair_kernel, a block a row i of X: P_i = (M A)[i, :] = the sum of
//    A's rows in L_i goes to shared memory (h floats, coalesced reads of
//    A, L_i staged in shared memory so that the loads of A's rows are
//    independent), then a thread a column j writes X[i, j] = sum over k in
//    L_j of M[j, k] P_i[k], the lists read from L2, each thread loading
//    four columns' counts and first entries at once; the row of X is
//    written once, coalesced.  An empty row i writes zeros and reads
//    nothing more.
// At the host CGM's k = 81 this runs 81 blocks, each reading only its own
// rows of A.  The form is exact for any 0/1 M (a slot in several groups
// too: the kernel bench's M has ~16 ones a column), and nothing is decided
// on the host from the data.
// Exact in any order: M holds 0/1, so a nonzero of M stands for a 1; P_i
// holds integers up to h and X integers below 2^24 (the caller checks
// h(h-1)/2 < 2^24), so the fp32 sums are exact and equal the plain PyTorch
// M @ A @ M^T bit for bit.  P_i stays fp32: bf16 is exact only up to 256.
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // 32-column words a lane loads at once
constexpr int kSMs = 132;      // an H100 SXM
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
list_kernel(const float* __restrict__ M, int* __restrict__ cols,
            int* __restrict__ count, int S, int h) {
  M += static_cast<size_t>(blockIdx.y) * S * h;
  cols += static_cast<size_t>(blockIdx.y) * S * h;
  count += static_cast<size_t>(blockIdx.y) * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int words = (h + 31) / 32;
  for (int j = blockIdx.x * kWarps + warp; j < S; j += gridDim.x * kWarps) {
    const float* row = M + static_cast<size_t>(j) * h;
    int z = 0;
    for (int w0 = 0; w0 < words; w0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = (w0 + u) * 32 + lane;
        v[u] = c < h ? row[c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned m = __ballot_sync(kAll, v[u] != 0.0f);
        if (v[u] != 0.0f)
          cols[static_cast<size_t>(z + __popc(m & below)) * S + j] =
              (w0 + u) * 32 + lane;
        z += __popc(m);
      }
    }
    if (lane == 0) count[j] = z;
  }
}

// Dynamic shared memory: P_i (h floats), then a chunk of row i's list.
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ A, const int* __restrict__ cols,
            const int* __restrict__ count, float* __restrict__ X, int S,
            int h) {
  extern __shared__ float P[];
  A += static_cast<size_t>(blockIdx.y) * h * h;
  cols += static_cast<size_t>(blockIdx.y) * S * h;
  count += static_cast<size_t>(blockIdx.y) * S;
  X += static_cast<size_t>(blockIdx.y) * S * S;
  int* lcol = reinterpret_cast<int*>(P + h);
  const int i = blockIdx.x;
  const int zi = count[i];
  float* xrow = X + static_cast<size_t>(i) * S;
  if (zi == 0) {
    for (int j = threadIdx.x; j < S; j += kThreads) xrow[j] = 0.0f;
    return;
  }
  for (int k = threadIdx.x; k < h; k += kThreads) P[k] = 0.0f;
  for (int t0 = 0; t0 < zi; t0 += kThreads) {
    const int tn = min(kThreads, zi - t0);
    __syncthreads();
    if (threadIdx.x < tn)
      lcol[threadIdx.x] = cols[static_cast<size_t>(t0 + threadIdx.x) * S + i];
    __syncthreads();
    for (int k = threadIdx.x; k < h; k += kThreads) {
      float acc = P[k];
#pragma unroll 4
      for (int t = 0; t < tn; ++t)
        acc += A[static_cast<size_t>(lcol[t]) * h + k];
      P[k] = acc;
    }
  }
  __syncthreads();
  // X[i, j] for kJ columns j a thread at once, their counts and first list
  // entries loaded together (most rows of M hold at most one slot)
  constexpr int kJ = 4;
  for (int j0 = threadIdx.x; j0 < S; j0 += kJ * kThreads) {
    int zj[kJ], c0[kJ];
#pragma unroll
    for (int u = 0; u < kJ; ++u) {
      const int j = j0 + u * kThreads;
      zj[u] = j < S ? count[j] : 0;
      c0[u] = j < S ? cols[j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kJ; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= S) break;
      float acc = zj[u] > 0 ? P[c0[u]] : 0.0f;
#pragma unroll 4
      for (int t = 1; t < zj[u]; ++t)
        acc += P[cols[static_cast<size_t>(t) * S + j]];
      xrow[j] = acc;
    }
  }
}

}  // namespace

// M: lanes x (S, h) float32, A: lanes x (h, h) float32, X: lanes x (S, S)
// float32, all contiguous; scratch: cols (lanes h S) int32, count (lanes
// S) int32.  The lane is the grid's y in both passes.  A block takes 4 h +
// 1 KB of shared memory: at most 24 KB under the caller's exactness bound
// (h <= 5793), within the 48 KB it has by default.
extern "C" int clique_pair_edges_lanes_launch(const float* M, const float* A,
                                              float* X, int* cols, int* count,
                                              int lanes, int S, int h,
                                              cudaStream_t stream) {
  if (S <= 0 || lanes <= 0) return static_cast<int>(cudaGetLastError());
  const int most = max(1, 8 * kSMs / lanes);      // list blocks a lane
  const int blocks = min((S + kWarps - 1) / kWarps, most);
  list_kernel<<<dim3(blocks, lanes), kThreads, 0, stream>>>(M, cols, count,
                                                            S, h);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (h + kThreads) * sizeof(int);
  pair_kernel<<<dim3(S, lanes), kThreads, smem, stream>>>(A, cols, count, X,
                                                          S, h);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(clique_pair_edges)
