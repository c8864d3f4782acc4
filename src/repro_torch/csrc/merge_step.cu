// Initial density matrix D of the approximate merge (paper Alg. 3), with
// the merge loop's act mask applied in the same pass (a laned call: S
// sweep lanes' matrices in one launch, the lane on the grid's z, each lane
// with its own omega, gamma and act count):
//
//   within[i] = X[i, i] / 2
//   e(i u j)  = (within[i] + within[j]) + X[i, j]
//   D[i, j]   = e / e_max   if |i| + |j| == omega and i != j, else -1
//   D[i, j]   = -1          where that density is below gamma
//   masked (k = n_act >= 0): D[i, j] = -2 unless i < k, j < k and i != j
//
// Replaces the TPU kernel repro/kernels/merge_step.py::merge_density
// (Pallas body _merge_density_kernel, one row block of D per grid step on
// the VPU) and, in the masked mode, the eye / act-pair / where passes that
// the reference's merge (core/cgm_jax.py::_approx_merge) runs after
// it.
//
// What bounds it on an H100: bytes.  A handful of operations per element;
// D is written once (4 S^2 bytes), and X is needed only at the entries
// whose size gate passes (inside the k x k act block when masked): every
// other entry is -1 or -2 whatever X holds.
//
// Design: a CTA of 256 threads owns a tile of kCols = 128 columns by
// tile_rows rows (32, 16 or 8).  It stages the tile's column side
// (within[j], sizes[j]) and its rows' sizes in shared memory once, one
// thread an entry; then each thread owns 4 consecutive columns and the 8
// warps walk the tile's rows (X[i, i] is loaded only where an entry
// passes).  No integer division.  X is read only for a group of 4 entries
// with one passing entry, by one 16-byte load where the row is 16-byte
// aligned; D is stored 16 bytes at a time where its row is aligned, else
// by a scalar path that checks each column (S need not be a multiple of 4,
// X may sit at any 4-byte offset).  A tile wholly outside the act block
// reads nothing and stores -2.
//
// The tile height is picked per launch from the act block's size: a warp
// walks its rows one after another, so a few tall tiles over a small
// block (n_act 229 of S 2048) take longer than the fill of all the rest.
// The launch takes the tallest of 32, 16 and 8 rows that still gives the
// block three CTAs a SM (the SM count read once a device).  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, the device time of
// one launch): at n_act 229 of S 2048, 8 rows 0.0057 ms against 0.0081 at
// 32 and 0.0110 at 64; at S 20,000, n_act 10,000, 32 rows 0.682 ms,
// within 2% of 16, 64 and 128 rows and ahead of 8 (0.734).  Streaming
// stores (st.global.cs) measured within 1% of plain ones there (0.681
// against 0.682 ms), and plain stores keep D in L2 for the merge loop's
// first argmax, so the kernel stores plainly.
//
// Designs measured slower on the same card: each thread gathering its 4
// columns' diagonal entries in registers (8 warps repeating the same
// scattered loads): S 20,000 unmasked 1.282 ms at 128 rows against this
// design's 1.216 in one run.  Loading a warp's rows ahead by lanes and
// shuffles, or all of its X groups before any store: 1.391-1.418 ms at
// S 20,000 unmasked and 0.746-0.890 ms at n_act 10,000 (128 rows),
// against 1.284 and 0.704 for the register gather in the same run.
//
// The float32 operation order is that of merge_density_jnp /
// core.cliques._densities, with every add and divide an explicit
// round-to-nearest intrinsic so no contraction or approximate division can
// change a bit: the result equals the plain PyTorch version bit for bit.
// e_max is computed in float64 by the caller and rounded once to float32,
// as the reference does.
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4 * 32;
// tile heights the launch picks from, tallest first, and the CTAs of the
// act block it wants at least on each SM: the tallest tile that still
// gives the block that many CTAs, else the shortest
constexpr int kTileRows[] = {32, 16, 8};
constexpr int kMaxTileRows = kTileRows[0];
constexpr int kLiveCtasPerSm = 3;
constexpr int kMaxDevices = 64;

// a laned call's per-lane knobs (device arrays, one entry a lane); the
// unlaned call passes null pointers and its knobs by value
struct LaneArgs {
  const int* omega;
  const float* gamma;
  const int* n_act;  // null: the TPU kernel's function in every lane
};

// omega (omega - 1) / 2 in float64, rounded once to float32: exact in
// float64 for any int omega, as the reference computes e_max
__device__ __forceinline__ float e_max_of(int omega) {
  const double om = static_cast<double>(omega);
  return __double2float_rn(om * (om - 1.0) / 2.0);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
merge_density_kernel(const float* __restrict__ X, const int* __restrict__ sizes,
                     float* __restrict__ D, int S, int lim, float fill,
                     int omega, float gamma, float e_max, int tile_rows,
                     const LaneArgs lanes) {
  if (lanes.omega != nullptr) {
    // a laned call: lane z's matrices and its own knobs
    const int z = blockIdx.z;
    X += static_cast<size_t>(z) * S * S;
    D += static_cast<size_t>(z) * S * S;
    sizes += static_cast<size_t>(z) * S;
    omega = lanes.omega[z];
    gamma = lanes.gamma[z];
    e_max = e_max_of(omega);
    if (lanes.n_act != nullptr) lim = min(max(lanes.n_act[z], 0), S);
  }
  // the tile's column side (within[j], sizes[j]) and row sizes, staged
  // once a CTA: threads 0-127 a column each, threads 128- a row each
  __shared__ __align__(16) float s_within[kCols];
  __shared__ __align__(16) int s_col[kCols];
  __shared__ int s_row[kMaxTileRows];
  const int cb = blockIdx.x * kCols;
  const int r0 = blockIdx.y * tile_rows;
  // the tile meets the act block (every tile of D when unmasked, lim == S)
  const bool live_tile = r0 < lim && cb < lim;
  if (live_tile) {
    const int t = threadIdx.x;
    if (t < kCols) {
      const int j = cb + t;
      if (j < lim) {
        s_col[t] = sizes[j];
        s_within[t] = __fdiv_rn(X[static_cast<size_t>(j) * S + j], 2.0f);
      }
    } else if (t - kCols < tile_rows && r0 + t - kCols < lim) {
      s_row[t - kCols] = sizes[r0 + t - kCols];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int c0 = cb + lane * 4;
  if (c0 >= S) return;  // no column of this thread lies in D
  const int ncols = min(4, S - c0);
  const int r_end = min(r0 + tile_rows, S);
  // bit c of `live`: column c0 + c lies in the act block
  unsigned live = 0;
  float4 wj = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int4 sj = make_int4(0, 0, 0, 0);
  if (live_tile) {
    for (int c = 0; c < 4; ++c)
      if (c0 + c < lim) live |= 1u << c;
    if (live != 0) {
      wj = reinterpret_cast<const float4*>(s_within)[lane];
      sj = reinterpret_cast<const int4*>(s_col)[lane];
    }
  }
  const float w_col[4] = {wj.x, wj.y, wj.z, wj.w};
  const int s_c[4] = {sj.x, sj.y, sj.z, sj.w};

  for (int i = r0 + (threadIdx.x >> 5); i < r_end; i += kWarps) {
    float v[4] = {fill, fill, fill, fill};
    if (live != 0 && i < lim) {
      const int si = s_row[i - r0];
      unsigned pass = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (((live >> c) & 1u) && c0 + c != i) {
          v[c] = -1.0f;
          // int32 wrap-around as the plain version's add
          if (static_cast<int>(static_cast<unsigned>(si) +
                               static_cast<unsigned>(s_c[c])) == omega)
            pass |= 1u << c;
        }
      }
      if (pass != 0) {
        const float* xr = X + static_cast<size_t>(i) * S;
        const float wi = __fdiv_rn(xr[i], 2.0f);
        float x[4];
        if (ncols == 4 && aligned16(xr + c0)) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(xr + c0));
          x[0] = q.x;
          x[1] = q.y;
          x[2] = q.z;
          x[3] = q.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            x[c] = ((pass >> c) & 1u) ? __ldg(xr + c0 + c) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if ((pass >> c) & 1u) {
            const float e_u = __fadd_rn(__fadd_rn(wi, w_col[c]), x[c]);
            const float dens = __fdiv_rn(e_u, e_max);
            v[c] = (dens >= gamma) ? dens : -1.0f;
          }
        }
      }
    }
    float* dr = D + static_cast<size_t>(i) * S + c0;
    if (ncols == 4 && aligned16(dr)) {
      *reinterpret_cast<float4*>(dr) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int c = 0; c < ncols; ++c) dr[c] = v[c];
    }
  }
}

// the current device's SM count, looked up once a device
cudaError_t current_sms(int* sms) {
  static int counts[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    e = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *sms = counts[dev];
  return cudaSuccess;
}

// the tile height for an act block of lim rows and columns in each of
// `lanes` lanes: the tallest that still gives three CTAs a SM
int pick_tile_rows(int lim, int lanes, int sms) {
  const long long live_cols = (lim + kCols - 1) / kCols;
  const long long want = static_cast<long long>(kLiveCtasPerSm) * sms;
  int tile_rows = 0;
  for (const int rows : kTileRows) {
    tile_rows = rows;
    if (lanes * live_cols * ((lim + rows - 1) / rows) >= want) break;
  }
  return tile_rows;
}

}  // namespace

// X: (S, S) float32, sizes: (S,) int32, D: (S, S) float32, all contiguous
// (X and sizes at any 4-byte offset).  n_act < 0: the TPU kernel's function;
// n_act = k in [0, S]: the act mask of the first k slots applied.
extern "C" int merge_density_launch(const float* X, const int* sizes, float* D,
                                    int S, int n_act, int omega, float gamma,
                                    float e_max, cudaStream_t stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lim = n_act < 0 ? S : n_act;
  const float fill = n_act < 0 ? -1.0f : -2.0f;
  const int tile_rows = pick_tile_rows(lim, 1, sms);
  const dim3 grid(static_cast<unsigned>((S + kCols - 1) / kCols),
                  static_cast<unsigned>((S + tile_rows - 1) / tile_rows));
  merge_density_kernel<<<grid, kThreads, 0, stream>>>(
      X, sizes, D, S, lim, fill, omega, gamma, e_max, tile_rows,
      LaneArgs{nullptr, nullptr, nullptr});
  return static_cast<int>(cudaGetLastError());
}

// The laned call: X lanes x (S, S) float32, sizes lanes x (S,) int32, D
// lanes x (S, S) float32, all contiguous; omega (lanes,) int32 and gamma
// (lanes,) float32 on the device, e_max derived per lane in the kernel;
// n_act (lanes,) int32 on the device (each clamped to [0, S]) or null (the
// TPU kernel's function), lim_max a bound on them (or S) that picks the
// tile height.
// The lane is the grid's z.
extern "C" int merge_density_lanes_launch(const float* X, const int* sizes,
                                          float* D, int lanes, int S,
                                          const int* omega, const float* gamma,
                                          const int* n_act, int lim_max,
                                          cudaStream_t stream) {
  if (S <= 0 || lanes <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0;
  const cudaError_t e = current_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float fill = n_act == nullptr ? -1.0f : -2.0f;
  const int tile_rows = pick_tile_rows(lim_max, lanes, sms);
  const dim3 grid(static_cast<unsigned>((S + kCols - 1) / kCols),
                  static_cast<unsigned>((S + tile_rows - 1) / tile_rows),
                  static_cast<unsigned>(lanes));
  merge_density_kernel<<<grid, kThreads, 0, stream>>>(
      X, sizes, D, S, S, fill, 0, 0.0f, 0.0f, tile_rows,
      LaneArgs{omega, gamma, n_act});
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(merge_density)
