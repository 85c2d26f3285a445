// B3 and B8: windowed, order-preserving stream compaction of a pad-coded
// stream (pad -1).
//
// Replaces sylph_tpu/tpu/bucket_fill.py::_repack1_flat_kernel (wrapper
// repack1_flat, int32 gid*64+mult codes, SENT -1) and
// ::_repack2_flat_kernel (wrapper repack2_flat, the (hi, lo) uint32 pair
// streams of read seeding, which are one int64 key here with pad -1), both
// of which condense each row-slot window with an LSB-first butterfly over
// [row/256, 256] tiles. Output contract: the stream is padded with -1 to
// nwin = 8 * ceil(n / (8 * row)) windows; window w's live (non-pad)
// entries, in order, fill out[w*cap : w*cap + cap]; entries past cap are
// dropped (callers check conservation) and the rest of the window's output
// is -1. The two Pallas bodies are one algorithm on two payloads, so one
// kernel template serves both.
//
// It also serves B11 and B12, the row repacks of pallas_seeding.py
// (::_repack_kernel, wrapper repack_pallas, on (hi, lo) pairs: the int64
// instance; ::_repack1_kernel, wrapper repack1_pallas, on uint32 codes: the
// int32 instance). Their contract is this one with windows called rows and
// nwin = the row count padded to a multiple of the Pallas row block, which
// the wrappers in sylph_tpu_torch/gpu/seeding.py compute; row and cap are
// multiples of 128 there, which the kernel takes as it takes any width.
//
// Bound on the H100: bytes. One read of the stream and one write of
// nwin*cap slots (4 B a slot for B3, 8 B for B8).
//
// Design: one 1024-thread block per window. Each pass takes 1024 slots:
// a warp ballot ranks the live entries inside each warp, warp 0 scans the
// 32 warp counts, and every live entry is written at its window rank while
// that rank is below cap. The block stops reading once its window is full.
// The pad of the input is never materialised: slots past n read as pad.

#include "common.cuh"

#define THREADS 1024

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
repack_kernel(const T* __restrict__ v, long long n, long long row,
              long long cap, T* __restrict__ out) {
  __shared__ int wcount[THREADS / 32];
  __shared__ int wtotal;
  const T pad = (T)-1;
  const long long win = blockIdx.x;
  const long long start = win * row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* o = out + win * cap;
  long long base = 0;                     // live entries placed so far
  for (long long off = 0; off < row && base < cap; off += THREADS) {
    const long long i = start + off + threadIdx.x;
    const T x = (off + threadIdx.x < row && i < n) ? v[i] : pad;
    const bool live = x != pad;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int c = wcount[lane];
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      wcount[lane] = incl - c;            // exclusive warp offsets
      if (lane == 31) wtotal = incl;
    }
    __syncthreads();
    const long long r = base + wcount[warp] + __popc(m & lanemask_lt());
    if (live && r < cap) o[r] = x;
    base += wtotal;
    __syncthreads();                      // wcount/wtotal reused next pass
  }
  for (long long r = min(base, cap) + threadIdx.x; r < cap; r += THREADS)
    o[r] = pad;
}

template <typename T>
int launch(const T* v, long long n, long long row, long long cap,
           long long nwin, T* out, void* stream) {
  if (nwin > 0) {
    repack_kernel<T><<<static_cast<unsigned>(nwin), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(v, n, row, cap,
                                                            out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3: int32 code streams (SENT = -1)
extern "C" int repack_launch(const int* v, long long n, long long row,
                             long long cap, long long nwin, int* out,
                             void* stream) {
  return launch<int>(v, n, row, cap, nwin, out, stream);
}

// B8: int64 hash-key streams (pad = -1)
extern "C" int repack64_launch(const long long* v, long long n,
                               long long row, long long cap, long long nwin,
                               long long* out, void* stream) {
  return launch<long long>(v, n, row, cap, nwin, out, stream);
}
