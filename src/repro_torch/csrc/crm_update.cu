// Window co-occurrence counts of the CRM (paper Alg. 2): out = H^T H with a
// zero diagonal, H the (rows, h) 0/1 request x hot-item incidence; a laned
// call counts S such incidences (one a sweep lane: the lanes share the
// window but not their hot sets) in one launch, the lane on the grid's y.
//
// Replaces the TPU kernel repro/kernels/crm_update.py::crm_update (Pallas
// body _crm_kernel): a transpose-matmul tiled over (h/bm, h/bn) output
// blocks with the request axis as a sequential grid dimension accumulating
// in VMEM.
//
// What bounds it on an H100: bytes.  The replay's H has at most 5 ones a
// row (the device CGM's slot buffer, the host CGM's padded item ids), so
// a row adds at most 20 ordered pairs against h * 4 bytes read: at
// catalog-10k's device CGM (22,912 x 1024) H is 94 MB and the pairs at
// most 0.46 M, at the host CGM's (255,498 x 1000) 1 GB and 5.1 M.  Reading H once at the
// HBM rate is the least time; a dense product's 2 rows h^2 multiply-adds
// are nearly all of zeros.
//
// Design: one pass over H, each row's pairs of nonzero columns counted
// into the output.  The launch picks one of three paths by h and the rows
// and reports it (0 narrow, 1 mid, 2 wide).
// * h > 64, or 32 < h <= 64 on few rows (crm_wide_kernel): a warp a
//   row.  Each lane loads 8 columns 32 apart before it looks at any
//   (coalesced 4-byte loads, 1 KB in
//   flight a warp, no alignment needed: at the device CGM the row stride
//   is h + 1).  A ballot per 32 columns gives the nonzero columns, kept in
//   a per-warp list of up to kCap entries; then the warp adds 1 for every
//   ordered pair a != b of the list, a lane a pair, with atomicAdd into
//   the output in device memory (it resolves in L2: 4 MB at h 1024).  A
//   row with more than kCap nonzeros (the kernel bench has ~31, a dense
//   test row h) walks its 32-column ballot masks word pair by word pair
//   instead: right for any 0/1 H, fast only for sparse rows.  Atomics were
//   chosen over output tiles in shared memory because a tile per block
//   would need every block to read all of H (or a compaction pass first),
//   and the pairs are few: at most one atomic per 200 bytes read at
//   catalog-10k.
// * 32 < h <= 64 (crm_mid_kernel), when the wide grid (at most 8 blocks
//   of 8 warps a SM) would give a warp more than one row: a lane a row,
//   its columns one 64-bit mask.  A warp takes 32 rows at once and loads
//   16 of them before it looks at any: lane l reads columns l and l + 32
//   of each (coalesced 4-byte loads, 32 in flight a lane, any row stride,
//   no division by it), and two ballots a row give the row's mask, which
//   lane k keeps for row k.  Lanes whose rows are equal (the traces'
//   popular bundles) count once, their lowest lane adding the
//   multiplicity (__match_any_sync).  Each lane adds its row's pairs a < b
//   (half the ordered pairs) into the block's (h, h) integer counts in
//   shared memory (at most 16 KB); at the end each block adds its nonzero
//   counts to both triangles of the zeroed output with float atomics.  The
//   grid is at most 4 blocks a SM, all resident at once (a second wave
//   would double the time), split evenly over the lanes.  It replaced the
//   wide design at fig7's 17 lanes of h 60, where a warp a row loaded two
//   useful words of eight and kept one 240-byte row in flight (times on
//   an NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 6).  In
//   development runs on that card, thread-block clusters that summed
//   their counts in distributed shared memory before one flush a cluster
//   ran slower than more blocks with a flush each, as did fewer, larger
//   blocks.  On few rows (the expert cache's one lane of 192) the wide
//   design's one load round is a shorter chain than this design's two
//   rounds, two block barriers and flush: there it takes half the time.
//   The two cross between one and two rows a warp of the wide grid at 17
//   lanes of h 60 and below one row a warp at one lane of h 40 (on an
//   NVIDIA H100 80GB HBM3 at 700 W, src/repro_torch/bench/kernel_ab.py),
//   so the rule takes one.
// * h <= 32 (crm_narrow_kernel): a lane a row (a warp a row would leave
//   26 of 32 lanes idle at the host CGM's h 6).  A warp reads 32 to 1,024
//   consecutive rows (about 1,000 entries) with coalesced loads, 32
//   consecutive entries and 16 loads in flight a lane; each nonzero sets
//   its column's bit in its row's mask in shared memory.  Then each lane
//   counts its rows' pairs into the block's (h, h) integer counts in
//   shared memory, which go to the output once at the end.  The counts
//   are integers because integer shared-memory atomics are native and
//   float ones a compare-and-swap loop.  Each lane walks its own pairs:
//   a warp summing each pair over its lanes with shuffles would add once
//   a pair a warp (the Zipf traces' popular pairs), but would walk every
//   pair present in any of its 32 rows, hundreds at h 32.
// Exact in any order: the kernel counts the rows in which both columns
// are nonzero, which is H^T H for the 0/1 H the callers pass; every count
// is an integer below 2^24 (rows < 2^24 is checked by the caller), so the
// integer counts and the float adds of integers, atomics included, are
// exact, and the result equals the plain PyTorch product bit for bit
// however the atomics interleave.  The diagonal receives no adds and stays
// zero.  The row stride ``ld`` lets the caller pass the leading h columns
// of a wider (rows, h + 1) buffer.
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;       // 32-column words a lane loads at once
constexpr int kCap = 64;         // nonzeros of a row kept as a list
constexpr int kNarrow = 32;      // h up to which a lane takes a row
constexpr int kMid = 64;         // h up to which a lane's row is one mask
constexpr int kBatch = 16;       // rows a warp loads at once (mid)
constexpr int kMidPerSm = 4;     // mid blocks resident on a SM
constexpr int kLoads = 16;       // loads in flight a lane (narrow)
constexpr int kSMs = 132;        // an H100 SXM
constexpr unsigned kAll = 0xffffffffu;

// the paths, as crm_update_lanes_launch reports them
enum Path { kNarrowPath = 0, kMidPath = 1, kWidePath = 2 };

// Rows a lane takes at once at h <= 32: about 1,000 entries a warp.
__host__ __device__ inline int rows_per_lane(int h) {
  return max(1, 32 / h);
}

// Dynamic shared memory: the block's (h, h) counts, then one mask a row
// of each warp's rows.
__global__ void __launch_bounds__(kThreads)
crm_narrow_kernel(const float* __restrict__ H, float* __restrict__ out,
                  int rows, int h, int ld, long long lane_stride) {
  extern __shared__ int cnt[];
  H += blockIdx.y * lane_stride;
  out += static_cast<size_t>(blockIdx.y) * h * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_lane = rows_per_lane(h);
  const int span = 32 * per_lane;                 // rows a warp step
  unsigned* wmask = reinterpret_cast<unsigned*>(cnt + h * h) + warp * span;
  for (int e = threadIdx.x; e < h * h; e += kThreads) cnt[e] = 0;
  for (int t = 0; t < per_lane; ++t) wmask[lane + 32 * t] = 0u;
  __syncthreads();
  for (int base = (blockIdx.x * kWarps + warp) * span; base < rows;
       base += gridDim.x * kWarps * span) {
    const int n = min(span, rows - base) * h;     // the step's entries
    for (int e0 = 0; e0 < n; e0 += 32 * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * 32 + lane;
        const int rr = e / h;
        v[u] = e < n ? H[static_cast<size_t>(base + rr) * ld + (e - rr * h)]
                     : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (v[u] == 0.0f) continue;
        const int e = e0 + u * 32 + lane;
        const int rr = e / h;
        atomicOr(&wmask[rr], 1u << (e - rr * h));
      }
    }
    __syncwarp();
    for (int t = 0; t < per_lane; ++t) {
      const int rr = lane + 32 * t;
      const unsigned mask = wmask[rr];
      wmask[rr] = 0u;
      for (unsigned ra = mask; ra; ra &= ra - 1u) {
        const int a = __ffs(ra) - 1;
        for (unsigned rb = mask & ~(1u << a); rb; rb &= rb - 1u)
          atomicAdd(&cnt[a * h + __ffs(rb) - 1], 1);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int e = threadIdx.x; e < h * h; e += kThreads)
    if (cnt[e] != 0) atomicAdd(out + e, static_cast<float>(cnt[e]));
}

// Dynamic shared memory: the block's (h, h) counts, of which the pairs
// a < b are used; they go to the zeroed output once at the end, both
// triangles.
__global__ void __launch_bounds__(kThreads, kMidPerSm)
crm_mid_kernel(const float* __restrict__ H, float* __restrict__ out,
               int rows, int h, int ld, long long lane_stride) {
  extern __shared__ int cnt[];
  H += blockIdx.y * lane_stride;
  out += static_cast<size_t>(blockIdx.y) * h * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool upper = lane + 32 < h;               // column lane + 32 exists
  for (int e = threadIdx.x; e < h * h; e += kThreads) cnt[e] = 0;
  __syncthreads();
  for (int base = (blockIdx.x * kWarps + warp) * 32; base < rows;
       base += gridDim.x * kWarps * 32) {
    unsigned long long mine = 0ull;             // the mask of row base + lane
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += kBatch) {
      float lo[kBatch], hi[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int r = base + k0 + k;
        const float* row = H + static_cast<size_t>(r) * ld;
        lo[k] = r < rows ? row[lane] : 0.0f;
        hi[k] = r < rows && upper ? row[lane + 32] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned long long m =
            __ballot_sync(kAll, lo[k] != 0.0f) |
            static_cast<unsigned long long>(
                __ballot_sync(kAll, hi[k] != 0.0f)) << 32;
        if (lane == k0 + k) mine = m;
      }
    }
    // lanes holding equal rows count them once, their lowest lane adding
    // the multiplicity
    const unsigned peers = __match_any_sync(kAll, mine);
    if (__popcll(mine) > 1 && (peers & ((1u << lane) - 1u)) == 0u) {
      const int w = __popc(peers);
      for (unsigned long long ra = mine; ra;) {
        const int a = __ffsll(ra) - 1;
        ra &= ra - 1ull;
        for (unsigned long long rb = ra; rb; rb &= rb - 1ull)
          atomicAdd(&cnt[a * h + __ffsll(rb) - 1], w);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < h * h; e += kThreads) {
    const int a = e / h;
    const int b = e - a * h;
    if (a < b && cnt[e] != 0) {
      const float v = static_cast<float>(cnt[e]);
      atomicAdd(out + e, v);
      atomicAdd(out + b * h + a, v);
    }
  }
}

// Dynamic shared memory: per warp kCap columns and one ballot mask per 32
// columns of the row.
__global__ void __launch_bounds__(kThreads)
crm_wide_kernel(const float* __restrict__ H, float* __restrict__ out,
                int rows, int h, int ld, long long lane_stride) {
  extern __shared__ int lists[];
  H += blockIdx.y * lane_stride;
  out += static_cast<size_t>(blockIdx.y) * h * h;
  const int words = (h + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* cols = lists + warp * (kCap + words);
  unsigned* masks = reinterpret_cast<unsigned*>(cols + kCap);
  const unsigned below = (1u << lane) - 1u;
  for (int r = blockIdx.x * kWarps + warp; r < rows;
       r += gridDim.x * kWarps) {
    const float* row = H + static_cast<size_t>(r) * ld;
    int z = 0;                                    // nonzeros so far
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
        if (lane == 0 && w0 + u < words) masks[w0 + u] = m;
        const int pos = z + __popc(m & below);
        if (v[u] != 0.0f && pos < kCap) cols[pos] = (w0 + u) * 32 + lane;
        z += __popc(m);
      }
    }
    __syncwarp();
    if (z <= kCap) {
      for (int p = lane; p < z * z; p += 32) {
        const int a = p / z;
        const int b = p - a * z;
        if (a != b)
          atomicAdd(out + static_cast<size_t>(cols[a]) * h + cols[b], 1.0f);
      }
    } else {
      // a dense row: every pair of nonempty 32-column words, lane = a
      for (int wi = 0; wi < words; ++wi) {
        const unsigned mi = masks[wi];
        if (!((mi >> lane) & 1u)) continue;
        const int a = wi * 32 + lane;
        for (int wj = 0; wj < words; ++wj) {
          for (unsigned rb = masks[wj]; rb; rb &= rb - 1u) {
            const int b = wj * 32 + __ffs(rb) - 1;
            if (a != b) atomicAdd(out + static_cast<size_t>(a) * h + b, 1.0f);
          }
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// H: lanes x (rows, ld) float32 with the first h columns used, lane l at
// H + l lane_stride; out: lanes x (h, h) float32, contiguous, zeroed here.
// The lanes ride the grid's y axis: each lane gets blocks in proportion to
// its rows, the whole grid at most 8 blocks a SM (4 on the mid path; as
// one unlaned call).  Writes the path it takes to *path (0 narrow, 1 mid,
// 2 wide; -1 when h or lanes is 0).
extern "C" int crm_update_lanes_launch(const float* H, float* out, int lanes,
                                       int rows, int h, int ld,
                                       long long lane_stride, int* path,
                                       cudaStream_t stream) {
  *path = -1;
  if (h <= 0 || lanes <= 0) return static_cast<int>(cudaGetLastError());
  const int most = max(1, 8 * kSMs / lanes);      // blocks a lane
  // the wide design while its grid gives a warp at most one row; the mid
  // design when its warps would walk more
  *path = h <= kNarrow ? kNarrowPath
          : (h <= kMid && rows > kWarps * most ? kMidPath : kWidePath);
  const cudaError_t zeroed = cudaMemsetAsync(
      out, 0, static_cast<size_t>(lanes) * h * h * sizeof(float), stream);
  if (zeroed != cudaSuccess || rows <= 0) return static_cast<int>(zeroed);
  const size_t smem_counts = static_cast<size_t>(h) * h * sizeof(int);
  if (*path == kNarrowPath) {
    const int block_rows = kThreads * rows_per_lane(h);
    const int blocks = min((rows + block_rows - 1) / block_rows, most);
    const size_t smem = smem_counts + block_rows * sizeof(int);
    crm_narrow_kernel<<<dim3(blocks, lanes), kThreads, smem, stream>>>(
        H, out, rows, h, ld, lane_stride);
    return static_cast<int>(cudaGetLastError());
  }
  if (*path == kMidPath) {
    // all blocks resident at once: a second wave would double the time
    const int blocks = min((rows + kThreads - 1) / kThreads,
                           max(1, kMidPerSm * kSMs / lanes));
    crm_mid_kernel<<<dim3(blocks, lanes), kThreads, smem_counts, stream>>>(
        H, out, rows, h, ld, lane_stride);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      static_cast<size_t>(kWarps) * (kCap + (h + 31) / 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crm_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = min((rows + kWarps - 1) / kWarps, most);
  crm_wide_kernel<<<dim3(blocks, lanes), kThreads, smem, stream>>>(
      H, out, rows, h, ld, lane_stride);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(crm_update)
