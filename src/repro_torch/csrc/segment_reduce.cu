// Segmented inclusive running max, and running (max, latest argmax), over
// one step's event stream of the host-schedule replay (paper Alg. 6 under
// per-server dt: anchor resolution and post-batch pair expiry).
//
// Replaces the TPU kernels repro/kernels/segment_reduce.py::seg_running_max
// and ::seg_running_argmax (Pallas bodies _segmax_kernel / _segargmax_kernel):
// log2(L) Hillis-Steele rounds of shift + select on one (1, L) block in VMEM,
// segment ids from a cumulative sum of the start flags.
//
// What bounds it on an H100: bytes, far below launch overhead.  One call
// reads L float64 values and L start flags and writes L float64 values (and
// L int32 indices): about 150 KB at the replay's L = 8192, well under a
// microsecond at 3.35 TB/s.  The work is a scan with a carried index, so a
// single block does it and the launch, not the card, sets the time.
//
// Design: one block of 1024 threads per call.  Each thread walks one
// contiguous chunk of ceil(L / 1024) positions sequentially and keeps a
// summary (value, index, whether a segment starts inside the chunk).  The
// block scans the 1024 summaries in shared memory (ten doubling rounds), and
// a second pass walks each chunk again, seeded with the prefix carried in
// from the chunks before it, and writes the outputs.
//
// The operator is the reference's: a position that does not start a segment
// takes its predecessor's running pair only when that value is STRICTLY
// greater, so ties keep the later index (the scalar ``touch`` rule's >=).
// Position 0 always starts a segment, whatever starts[0] says.  The operator
// is associative, and it only selects values, so the result equals the
// oracle and the plain PyTorch version bit for bit.
#include "launch.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;

struct Run {
  double v;
  int i;
  bool s;   // a segment starts inside the span this summary covers
};

// a covers the span just before b's
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  if (b.s) return b;
  Run r;
  r.s = a.s;
  if (a.v > b.v) {
    r.v = a.v;
    r.i = a.i;
  } else {
    r.v = b.v;
    r.i = b.i;
  }
  return r;
}

template <bool kIndex>
__global__ void __launch_bounds__(kThreads)
seg_scan_kernel(const double* __restrict__ values,
                const unsigned char* __restrict__ starts,
                double* __restrict__ out_v, int* __restrict__ out_i, int L,
                int chunk) {
  __shared__ double sv[kThreads];
  __shared__ int si[kThreads];
  __shared__ unsigned char ss[kThreads];
  const int t = threadIdx.x;
  const int b = t * chunk;
  const int e = min(L, b + chunk);

  // pass 1: this chunk's summary
  Run r{-CUDART_INF, 0, false};
  if (b < e) {
    r = Run{values[b], b, b == 0 || starts[b] != 0};
    for (int k = b + 1; k < e; ++k) {
      const double x = values[k];
      if (starts[k]) {
        r = Run{x, k, true};
      } else if (!(r.v > x)) {
        r.v = x;
        r.i = k;
      }
    }
  }
  sv[t] = r.v;
  si[t] = r.i;
  ss[t] = r.s;
  __syncthreads();

  // inclusive scan of the summaries (empty chunks lie only at the tail, so
  // no real chunk ever combines with one)
  for (int d = 1; d < kThreads; d <<= 1) {
    Run a{0.0, 0, false};
    const bool has = t >= d;
    if (has) a = Run{sv[t - d], si[t - d], ss[t - d] != 0};
    __syncthreads();
    if (has) {
      r = combine(a, r);
      sv[t] = r.v;
      si[t] = r.i;
      ss[t] = r.s;
    }
    __syncthreads();
  }

  // pass 2: walk the chunk again from the carried-in prefix
  if (b >= e) return;
  double cv = 0.0;
  int ci = 0;
  if (t > 0) {
    cv = sv[t - 1];
    ci = si[t - 1];
  }
  for (int k = b; k < e; ++k) {
    const double x = values[k];
    if (k == 0 || starts[k] || !(cv > x)) {
      cv = x;
      ci = k;
    }
    out_v[k] = cv;
    if (kIndex) out_i[k] = ci;
  }
}

int launch(const double* values, const unsigned char* starts, double* out_v,
           int* out_i, int L, cudaStream_t stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  const int chunk = (L + kThreads - 1) / kThreads;
  if (out_i != nullptr) {
    seg_scan_kernel<true><<<1, kThreads, 0, stream>>>(values, starts, out_v,
                                                      out_i, L, chunk);
  } else {
    seg_scan_kernel<false><<<1, kThreads, 0, stream>>>(values, starts, out_v,
                                                       nullptr, L, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (L,) float64, starts (L,) bool (one byte each) -> out_v (L,) float64
extern "C" int seg_running_max_launch(const double* values,
                                      const unsigned char* starts,
                                      double* out_v, int L,
                                      cudaStream_t stream) {
  return launch(values, starts, out_v, nullptr, L, stream);
}

// the same, plus out_i (L,) int32: the latest index attaining the max
extern "C" int seg_running_argmax_launch(const double* values,
                                         const unsigned char* starts,
                                         double* out_v, int* out_i, int L,
                                         cudaStream_t stream) {
  return launch(values, starts, out_v, out_i, L, stream);
}

REPRO_EXPORT_ERROR_STRING(segment_reduce)
