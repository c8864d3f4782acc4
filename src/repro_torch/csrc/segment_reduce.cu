// Segmented inclusive running max, and running (max, latest argmax), over
// one step's event stream of the host-schedule replay (paper Alg. 6 under
// per-server dt: anchor resolution and post-batch pair expiry).
//
// Replaces the TPU kernels repro/kernels/segment_reduce.py::seg_running_max
// and ::seg_running_argmax (Pallas bodies _segmax_kernel / _segargmax_kernel):
// log2(L) Hillis-Steele rounds of shift + select on one (1, L) block in VMEM,
// segment ids from a cumulative sum of the start flags.
//
// What bounds it on an H100: bytes, far below launch overhead at the
// replay's L = 8192.  One lane reads L float64 values and L start flags and
// writes L float64 values (and L indices): about 150 KB, 0.05 us at
// 3.35 TB/s.  The scan carries an index, so one CTA takes a lane; what the
// card can do about the rest is to keep that CTA's own work short: few
// barriers, loads in flight at once, and coalesced stores.
//
// Scenario lanes: a sweep replays S pricing scenarios over one shared
// schedule, so under per-server dt each lane has its own values over the
// same start flags: values (S, L), starts (L,).  CTA (., y) takes lane y;
// the lanes are independent scans, each exactly the one-lane scan.
//
// Per-lane event rows: trace shards and cohorts of schedules give each
// lane its own schedule.  seg_scan_step then takes (G, L) event rows and
// an (S,) map from lane to row; the CTA of lane y offsets its six event
// pointers by rows[y] * L and scans as before.  The standalone scans take
// (S, L) starts, a start mask a lane, the same way.  Offsets need no
// alignment: the tiles peel whatever a row's address leaves.
//
// Design (one CTA of 512 threads per (problem, lane), no cluster):
// * The lane is walked in tiles of up to 8192 positions.  A tile's values
//   and start flags are staged in dynamic shared memory (80 KB, above the
//   48 KB static limit through cudaFuncSetAttribute) with 16-byte cp.async
//   copies; a misaligned head and an odd tail are peeled with 8-byte ones
//   in the same loop, so any row offset takes one code path, and every
//   load of a tile is in flight before the CTA waits once.
// * Each thread scans 16 consecutive positions out of shared memory (eight
//   16-byte loads; two words of padding after every 16 keep a quarter
//   warp's loads in distinct banks), a warp scans the 32 thread summaries
//   (value, index, whether a segment starts inside) with __shfl_up_sync in
//   5 steps, one warp scans the 16 warp totals: four barriers a tile in
//   place of the earlier design's 20.  Pass 2 walks the thread's values
//   again from registers, seeded with its prefix, writes the results into
//   shared memory, and the CTA stores them coalesced, 16-byte where the
//   output row is aligned.
// * A lane longer than a tile (L up to 100,000 in the checks) is walked tile
//   by tile inside the CTA with the (value, index) prefix carried over; no
//   look-back across blocks.
// * seg_scan_step_launch does both scans of one replay step in one launch:
//   a grid of 2 x S CTAs, x 0 the argmax scan of t_s + dt[lane, j_s] over
//   first_cs (int64 index out), x 1 the max scan of cj_t_s + dt[lane,
//   cj_j_s] over first_cjs.  t and j are staged like values (j in the
//   index buffer, free until pass 2) and each operand is formed in pass 1
//   with __dadd_rn (PyTorch's add rounds the same way), dt's lane staged in
//   shared memory when it has at most 4096 servers, else read through L2.
//
// The operator is the reference's: a position that does not start a segment
// takes its predecessor's running pair only when that value is STRICTLY
// greater, so ties keep the later index (the scalar ``touch`` rule's >=).
// Position 0 always starts a segment, whatever starts[0] says.  The operator
// is associative, and it only selects values, so the result equals the
// oracle and the plain PyTorch version bit for bit.
#include "launch.cuh"

#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // consecutive positions a thread scans
constexpr int kTile = kThreads * kItems;    // positions a tile
constexpr int kStride = kItems + 2;         // a thread's words in shared memory
constexpr int kPadded = kThreads * kStride;  // words of one tile buffer
constexpr int kDtCap = 4096;                // dt lanes up to this go to shared

// shared memory slot of a tile's logical position q
__device__ __forceinline__ int slot(int q) { return q + 2 * (q / kItems); }

struct Run {
  double v;
  int i;
  bool s;  // a segment starts inside the span this summary covers
};

// a covers the span just before b's
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  if (b.s) return b;
  return a.v > b.v ? Run{a.v, a.i, a.s} : Run{b.v, b.i, a.s};
}

template <bool kIndex>
__device__ __forceinline__ Run shfl_up(const Run& r, int d) {
  unsigned key = (kIndex ? static_cast<unsigned>(r.i) : 0u) |
                 (r.s ? 0x80000000u : 0u);
  key = __shfl_up_sync(0xffffffffu, key, d);
  return Run{__shfl_up_sync(0xffffffffu, r.v, d),
             static_cast<int>(key & 0x7fffffffu), (key >> 31) != 0};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct Shared {
  double* v;
  unsigned char* f;
  Run* wsum;
  Run* carry;
  void* idx;
};

__device__ __forceinline__ Shared carve(unsigned char* smem) {
  Shared s;
  s.v = reinterpret_cast<double*>(smem);
  s.f = smem + kPadded * sizeof(double);
  s.wsum = reinterpret_cast<Run*>(s.f + kTile);
  s.carry = s.wsum + kWarps;
  s.idx = s.carry + 2;
  return s;
}

// Copy a tile's 8-byte elements into their slots, asynchronously: g is the
// global address of logical slot q = 0, slots [a, a + n) are valid.
// 16-byte copies where g is 16-byte aligned, else (and at a peeled head or
// tail) 8-byte ones.
__device__ __forceinline__ void stage8(void* dst, const void* src, int n,
                                       int a) {
  const auto* g = static_cast<const unsigned long long*>(src);
  auto* d = static_cast<unsigned long long*>(dst);
  const bool wide = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  for (int c = threadIdx.x; c < kTile / 2; c += kThreads) {
    const int q = 2 * c;
    const bool v0 = q >= a && q < a + n;
    const bool v1 = q + 1 >= a && q + 1 < a + n;
    if (wide && v0 && v1) {
      cp_async16(d + slot(q), g + q);
    } else {
      if (v0) cp_async8(d + slot(q), g + q);
      if (v1) cp_async8(d + slot(q) + 1, g + q + 1);
    }
  }
}

// Each thread stages the 16 start flags it scans: one 16-byte async copy
// where aligned and whole, else 16 byte loads issued together.
__device__ __forceinline__ void stage_flags(unsigned char* sf,
                                            const unsigned char* g, int n,
                                            int a) {
  const int q0 = threadIdx.x * kItems;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0 && q0 >= a &&
      q0 + kItems <= a + n) {
    cp_async16(sf + q0, g + q0);
    return;
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int q = q0 + k;
    if (q >= a && q < a + n)
      w[k >> 2] |= static_cast<unsigned>(g[q] != 0) << (8 * (k & 3));
  }
  *reinterpret_cast<uint4*>(sf + q0) = make_uint4(w[0], w[1], w[2], w[3]);
}

// a lane's values row
struct RowSource {
  static constexpr bool kGather = false;
  const double* row;

  __device__ __forceinline__ void stage(const Shared& sh, int base, int n,
                                        int a) const {
    stage8(sh.v, row + base - a, n, a);
  }
  __device__ __forceinline__ double price(long long) const { return 0.0; }
};

// one replay step's operand t + dt[lane, j]: t and j are staged (j in the
// index buffer, free until pass 2), the add happens in pass 1
struct StepSource {
  static constexpr bool kGather = true;
  const double* t;
  const long long* j;
  const double* dt;  // this lane's m prices, in shared memory or global
  int m;

  __device__ __forceinline__ void stage(const Shared& sh, int base, int n,
                                        int a) const {
    stage8(sh.v, t + base - a, n, a);
    stage8(sh.idx, j + base - a, n, a);
  }
  // an id outside [0, m) (only a caller's fault) gives NaN, not a stray read
  __device__ __forceinline__ double price(long long s) const {
    return (s >= 0 && s < m) ? dt[s] : CUDART_NAN;
  }
};

constexpr int kBaseBytes =
    kPadded * sizeof(double) + kTile + (kWarps + 2) * sizeof(Run);

// Store a tile's 8-byte results from shared memory to dst0 (the address of
// logical slot 0): 16-byte stores when dst0 is 16-byte aligned, else 8-byte
// ones, coalesced either way.
__device__ __forceinline__ void store8(unsigned long long* dst0,
                                       const unsigned long long* src, int n,
                                       int a) {
  if ((reinterpret_cast<uintptr_t>(dst0) & 15) == 0) {
    for (int c = threadIdx.x; c < kTile / 2; c += kThreads) {
      const int q = 2 * c;
      const bool v0 = q >= a && q < a + n;
      const bool v1 = q + 1 >= a && q + 1 < a + n;
      const unsigned long long* s = src + slot(q);
      if (v0 && v1) {
        *reinterpret_cast<ulonglong2*>(dst0 + q) =
            *reinterpret_cast<const ulonglong2*>(s);
      } else {
        if (v0) dst0[q] = s[0];
        if (v1) dst0[q + 1] = s[1];
      }
    }
  } else {
    for (int q = threadIdx.x + a; q < a + n; q += kThreads)
      dst0[q] = src[slot(q)];
  }
}

__device__ __forceinline__ void store4(int* dst0, const int* src, int n,
                                       int a) {
  for (int q = threadIdx.x + a; q < a + n; q += kThreads)
    dst0[q] = src[slot(q)];
}

// One (problem, lane): scan L positions of `src` under `starts`, writing
// out_v (and out_i, of type IdxT, when kIndex).  `align` is the input row
// whose alignment fixes the tiles' slot offset, so that its 16-byte copies
// land whole.
template <bool kIndex, typename IdxT, typename Source>
__device__ void scan_lane(const Source& src, const double* align,
                          const unsigned char* __restrict__ starts,
                          double* __restrict__ out_v, IdxT* __restrict__ out_i,
                          int L, const Shared& sh) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int base = 0, tile = 0; base < L; ++tile) {
    const int a =
        static_cast<int>((reinterpret_cast<uintptr_t>(align + base) >> 3) & 1);
    const int n = min(L - base, kTile - a);
    if (tile > 0) __syncthreads();  // the last tile's stores read the buffers
    src.stage(sh, base, n, a);
    stage_flags(sh.f, starts + base - a, n, a);
    cp_async_wait_all();
    __syncthreads();

    // pass 1: this thread's 16 values and flags, and its summary
    double x[kItems];
    unsigned fl[kItems / 4];
    {
      const double2* pv = reinterpret_cast<const double2*>(sh.v + t * kStride);
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k) {
        const double2 d = pv[k];
        x[2 * k] = d.x;
        x[2 * k + 1] = d.y;
      }
      if constexpr (Source::kGather) {
        const auto* pj =
            reinterpret_cast<const longlong2*>(
                static_cast<const long long*>(sh.idx) + t * kStride);
#pragma unroll
        for (int k = 0; k < kItems / 2; ++k) {
          const longlong2 jj = pj[k];
          x[2 * k] = __dadd_rn(x[2 * k], src.price(jj.x));
          x[2 * k + 1] = __dadd_rn(x[2 * k + 1], src.price(jj.y));
        }
      }
      const uint4 w = *reinterpret_cast<const uint4*>(sh.f + t * kItems);
      fl[0] = w.x;
      fl[1] = w.y;
      fl[2] = w.z;
      fl[3] = w.w;
    }
    const int q0 = t * kItems;
    const int pos0 = base + q0 - a;
    const int lo = max(0, a - q0);
    const int hi = min(kItems, a + n - q0);  // valid slots [lo, hi), maybe none
    Run r{0.0, 0, true};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k < lo || k >= hi) continue;
      const int p = pos0 + k;
      const bool s = ((fl[k >> 2] >> (8 * (k & 3))) & 0xff) != 0 || p == 0;
      if (k == lo) {
        r = Run{x[k], p, s};
      } else if (s) {
        r = Run{x[k], p, true};
      } else if (!(r.v > x[k])) {
        r.v = x[k];
        r.i = p;
      }
    }

    // warp scan of the thread summaries, then one warp over the warp totals
    // (summaries of threads past the tile's end come after every real one)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run o = shfl_up<kIndex>(r, d);
      if (lane >= d) r = combine(o, r);
    }
    const Run excl = shfl_up<kIndex>(r, 1);
    if (lane == 31) sh.wsum[warp] = r;
    __syncthreads();
    if (warp == 0) {
      Run w = lane < kWarps ? sh.wsum[lane] : Run{0.0, 0, true};
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const Run o = shfl_up<kIndex>(w, d);
        if (lane >= d) w = combine(o, w);
      }
      if (lane < kWarps) sh.wsum[lane] = w;
    }
    __syncthreads();

    // the prefix before this thread: the carry, earlier warps, earlier lanes
    bool has = tile > 0;
    Run pre = has ? sh.carry[(tile - 1) & 1] : Run{0.0, 0, false};
    if (warp > 0) {
      pre = has ? combine(pre, sh.wsum[warp - 1]) : sh.wsum[warp - 1];
      has = true;
    }
    if (lane > 0) {
      pre = has ? combine(pre, excl) : excl;
      has = true;
    }

    // pass 2, from registers
    int ix[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      ix[k] = 0;
      if (k < lo || k >= hi) continue;
      const int p = pos0 + k;
      const bool s = ((fl[k >> 2] >> (8 * (k & 3))) & 0xff) != 0 || p == 0;
      if (!has || s || !(pre.v > x[k])) {
        pre.v = x[k];
        pre.i = p;
        has = true;
      }
      x[k] = pre.v;
      ix[k] = pre.i;
    }
    if (t == (a + n - 1) / kItems) sh.carry[tile & 1] = pre;
    {
      double2* pv = reinterpret_cast<double2*>(sh.v + t * kStride);
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k)
        pv[k] = make_double2(x[2 * k], x[2 * k + 1]);
    }
    if constexpr (kIndex) {
      IdxT* pi = static_cast<IdxT*>(sh.idx) + t * kStride;
#pragma unroll
      for (int k = 0; k < kItems / 2; ++k) {
        if constexpr (sizeof(IdxT) == 8) {
          reinterpret_cast<longlong2*>(pi)[k] =
              make_longlong2(ix[2 * k], ix[2 * k + 1]);
        } else {
          reinterpret_cast<int2*>(pi)[k] = make_int2(ix[2 * k], ix[2 * k + 1]);
        }
      }
    }
    __syncthreads();

    store8(reinterpret_cast<unsigned long long*>(out_v + base - a),
           reinterpret_cast<const unsigned long long*>(sh.v), n, a);
    if constexpr (kIndex) {
      if constexpr (sizeof(IdxT) == 8) {
        store8(reinterpret_cast<unsigned long long*>(out_i + base - a),
               static_cast<const unsigned long long*>(sh.idx), n, a);
      } else {
        store4(out_i + base - a, static_cast<const int*>(sh.idx), n, a);
      }
    }
    base += n;
  }
}

template <bool kIndex>
__global__ void __launch_bounds__(kThreads, 1)
seg_scan_kernel(const double* __restrict__ values,
                const unsigned char* __restrict__ starts, int starts_stride,
                double* __restrict__ out_v, int* __restrict__ out_i, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row = static_cast<long long>(blockIdx.y) * L;
  scan_lane<kIndex, int>(
      RowSource{values + row}, values + row,
      starts + static_cast<long long>(blockIdx.y) * starts_stride,
      out_v + row, kIndex ? out_i + row : nullptr, L, carve(smem));
}

__global__ void __launch_bounds__(kThreads, 1)
seg_scan_step_kernel(const double* __restrict__ t_a,
                     const long long* __restrict__ j_a,
                     const unsigned char* __restrict__ s_a,
                     const double* __restrict__ t_m,
                     const long long* __restrict__ j_m,
                     const unsigned char* __restrict__ s_m,
                     const long long* __restrict__ rows,
                     const double* __restrict__ dt, int m,
                     double* __restrict__ out_v,
                     long long* __restrict__ out_i,
                     double* __restrict__ out_vmax, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared sh = carve(smem);
  if (rows != nullptr) {  // this lane's event row
    const long long off = rows[blockIdx.y] * L;
    t_a += off;
    j_a += off;
    s_a += off;
    t_m += off;
    j_m += off;
    s_m += off;
  }
  const double* dtl = dt + static_cast<long long>(blockIdx.y) * m;
  if (m <= kDtCap) {
    // joins the first tile's copies: its wait and barrier cover it
    double* sdt = reinterpret_cast<double*>(static_cast<unsigned char*>(sh.idx) +
                                            kPadded * sizeof(long long));
    for (int k = threadIdx.x; k < m; k += kThreads) cp_async8(sdt + k, dtl + k);
    dtl = sdt;
  }
  if (blockIdx.x == 0) {
    scan_lane<true, long long>(StepSource{t_a, j_a, dtl, m}, t_a, s_a,
                               out_v + static_cast<long long>(blockIdx.y) * L,
                               out_i + static_cast<long long>(blockIdx.y) * L,
                               L, sh);
  } else {
    scan_lane<false, long long>(
        StepSource{t_m, j_m, dtl, m}, t_m, s_m,
        out_vmax + static_cast<long long>(blockIdx.y) * L, nullptr, L, sh);
  }
}

// Allow a kernel `bytes` of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = bytes;
  return e;
}

int launch(const double* values, const unsigned char* starts, int lane_starts,
           double* out_v, int* out_i, int S, int L, cudaStream_t stream) {
  const int stride = lane_starts ? L : 0;
  if (L <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  static int done_max[64], done_argmax[64];
  const dim3 grid(1, S);
  cudaError_t e;
  if (out_i != nullptr) {
    const int bytes = kBaseBytes + kPadded * sizeof(int);
    e = allow_smem(seg_scan_kernel<true>, bytes, done_argmax);
    if (e != cudaSuccess) return static_cast<int>(e);
    seg_scan_kernel<true><<<grid, kThreads, bytes, stream>>>(
        values, starts, stride, out_v, out_i, L);
  } else {
    e = allow_smem(seg_scan_kernel<false>, kBaseBytes, done_max);
    if (e != cudaSuccess) return static_cast<int>(e);
    seg_scan_kernel<false><<<grid, kThreads, kBaseBytes, stream>>>(
        values, starts, stride, out_v, nullptr, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (S, L) float64, starts (L,) bool (one byte each) shared by the S
// lanes, or (S, L) with lane_starts = 1 -> out_v (S, L) float64
extern "C" int seg_running_max_launch(const double* values,
                                      const unsigned char* starts,
                                      int lane_starts, double* out_v, int S,
                                      int L, cudaStream_t stream) {
  return launch(values, starts, lane_starts, out_v, nullptr, S, L, stream);
}

// the same, plus out_i (S, L) int32: the latest index in the lane attaining
// the max
extern "C" int seg_running_argmax_launch(const double* values,
                                         const unsigned char* starts,
                                         int lane_starts, double* out_v,
                                         int* out_i, int S, int L,
                                         cudaStream_t stream) {
  return launch(values, starts, lane_starts, out_v, out_i, S, L, stream);
}

// Both scans of one replay step: (t_a, j_a, s_a) and (t_m, j_m, s_m) are the
// step's event times (float64), server ids (int64, in [0, m)) and start
// flags: (L,) shared by the lanes when rows is null, else (G, L) rows with
// rows (S,) int64 in [0, G) naming lane y's row; dt (S, m) float64.
// Writes out_v (S, L) and out_i (S, L) int64, the running (max, latest
// argmax) of t_a + dt[lane, j_a], and out_vmax (S, L), the running max of
// t_m + dt[lane, j_m].
extern "C" int seg_scan_step_launch(const double* t_a, const long long* j_a,
                                    const unsigned char* s_a,
                                    const double* t_m, const long long* j_m,
                                    const unsigned char* s_m,
                                    const long long* rows, const double* dt,
                                    int m, double* out_v, long long* out_i,
                                    double* out_vmax, int S, int L,
                                    cudaStream_t stream) {
  if (L <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  static int done[64];
  const int bytes = kBaseBytes + kPadded * sizeof(long long) +
                    (m <= kDtCap ? m : 0) * static_cast<int>(sizeof(double));
  const cudaError_t e = allow_smem(
      seg_scan_step_kernel,
      kBaseBytes + kPadded * static_cast<int>(sizeof(long long)) +
          kDtCap * static_cast<int>(sizeof(double)),
      done);
  if (e != cudaSuccess) return static_cast<int>(e);
  seg_scan_step_kernel<<<dim3(2, S), kThreads, bytes, stream>>>(
      t_a, j_a, s_a, t_m, j_m, s_m, rows, dt, m, out_v, out_i, out_vmax, L);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_ERROR_STRING(segment_reduce)
