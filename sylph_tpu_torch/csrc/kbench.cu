// Microbenchmarks of the seed kernels' primitives on Hopper.
//
// Replaces scripts/kbench.py::make (its pallas_call runs one small body
// over a [65536, 256] uint32 batch in [256, 256] tiles): the identity
// (kbench.py:90), alu_chain (:69), roll_chain (:55) and sublane_roll_chain
// (:78) bodies, whose times attribute seed_pack_pallas's budget on the TPU.
// Here they become their Hopper analogues on the same [rows, 256] batch of
// 32-bit words (int32 bit patterns, uint32 arithmetic), plus the
// primitives of the first design of csrc/seed_pack.cu's row kernel (B6: a
// block of 256 threads a read, ranked through shared memory; the row
// kernel now ranks by warp ballots alone, common.cuh::rank_piece):
//   identity      a copy: the HBM round trip every other line pays
//   alu           y = x; y += x >> (1 + i % 7), i < steps (shifts and adds
//                 in inline PTX, so the compiler cannot fold the chain)
//   lane_roll     each 256-lane row rotated by 1 + i % 7 lanes a step
//                 through shared memory, one barrier a step (roll_chain
//                 (n, 256))
//   half_roll     each 128-lane half rotated so, steps / 2 steps
//                 (roll_chain(n, 128))
//   warp_roll     each 32-lane group rotated by __shfl_sync, no barrier
//   sublane_roll  each 256-row tile rotated by 1 + i % 7 rows a step
//                 (sublane_roll_chain), in 16-lane strips through shared
//                 memory
//   rank          that ranking pass `steps` times: a predicate (bit i % 31
//                 of the word), a warp ballot and __popc, the 8 warp counts
//                 scanned in shared memory, three barriers; y sums the
//                 exclusive ranks
//   barrier       alu with a __syncthreads() before every step (256-thread
//                 blocks, as that design): barrier minus alu is the
//                 barriers' cost
//   funnel        y = __funnelshift_r(y, x, 1 + i % 7), the seed kernels'
//                 word extraction, as a dependent chain
// The plain PyTorch version of each is in sylph_tpu_torch/kbench.py, which
// holds every kernel bit for bit against it before timing it.
//
// Bound on the H100: bytes (64 MB in, 64 MB out at the full batch) for the
// copies and rolls, int32 operations for the long alu, funnel and rank
// chains. Design: each line is as plain as its primitive allows, so that
// its time over the identity's is the primitive's cost.

#include "common.cuh"

#define KB_THREADS 256
#define KB_LANES 256     // lanes of a row
#define KB_TILE 256      // rows of a sublane-roll tile (the Pallas block)
#define ROWS_PB 4        // rows a block of the lane-roll kernels
#define STRIP 16         // lanes a block of the sublane-roll kernel
#define KB_FULL 0xffffffffu

namespace {

__device__ __forceinline__ unsigned shr_v(unsigned x, unsigned s) {
  unsigned r;
  asm volatile("shr.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

__device__ __forceinline__ unsigned add_v(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("add.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__global__ void __launch_bounds__(KB_THREADS)
kb_identity(const uint4* __restrict__ x, uint4* __restrict__ y) {
  const long long i = (long long)blockIdx.x * KB_THREADS + threadIdx.x;
  y[i] = x[i];
}

// alu (SYNC false) and barrier (SYNC true): four words a thread
template <int STEPS, bool SYNC>
__global__ void __launch_bounds__(KB_THREADS)
kb_alu(const uint4* __restrict__ x, uint4* __restrict__ y) {
  const long long i = (long long)blockIdx.x * KB_THREADS + threadIdx.x;
  const uint4 q = x[i];
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
  unsigned a[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    if (SYNC) __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = add_v(a[j], shr_v(u[j], 1 + s % 7));
  }
  y[i] = make_uint4(a[0], a[1], a[2], a[3]);
}

template <int STEPS>
__global__ void __launch_bounds__(KB_THREADS)
kb_funnel(const uint4* __restrict__ x, uint4* __restrict__ y) {
  const long long i = (long long)blockIdx.x * KB_THREADS + threadIdx.x;
  const uint4 q = x[i];
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
  unsigned a[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = __funnelshift_r(a[j], u[j], 1 + s % 7);
  y[i] = make_uint4(a[0], a[1], a[2], a[3]);
}

// lane rolls: ROWS_PB rows a block, thread t holds lane t of each; W = 256
// rotates whole rows, W = 128 each half (STEPS / 2 steps, as roll_chain)
template <int STEPS, int W>
__global__ void __launch_bounds__(KB_THREADS)
kb_lane_roll(const unsigned* __restrict__ x, unsigned* __restrict__ y) {
  __shared__ unsigned buf[2][ROWS_PB][KB_LANES];
  const int lane = threadIdx.x;
  const long long base = (long long)blockIdx.x * ROWS_PB * KB_LANES;
  const int seg = lane & ~(W - 1), pos = lane & (W - 1);
  constexpr int NS = W == KB_LANES ? STEPS : STEPS / 2;
  unsigned v[ROWS_PB];
#pragma unroll
  for (int r = 0; r < ROWS_PB; ++r) v[r] = x[base + r * KB_LANES + lane];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    // double-buffered: a write to buf[p] two steps on follows a barrier
    // that every read of buf[p] precedes
    const int p = s & 1;
    const int dst = seg + ((pos + 1 + s % 7) & (W - 1));
#pragma unroll
    for (int r = 0; r < ROWS_PB; ++r) buf[p][r][dst] = v[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS_PB; ++r) v[r] = buf[p][r][lane];
  }
#pragma unroll
  for (int r = 0; r < ROWS_PB; ++r) y[base + r * KB_LANES + lane] = v[r];
}

// warp rolls: four words a thread, each in a warp of 32 neighbouring lanes
template <int STEPS>
__global__ void __launch_bounds__(KB_THREADS)
kb_warp_roll(const unsigned* __restrict__ x, unsigned* __restrict__ y) {
  const long long nt = (long long)gridDim.x * KB_THREADS;
  const long long t = (long long)blockIdx.x * KB_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  unsigned v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = x[t + j * nt];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int src = (lane - (1 + s % 7)) & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __shfl_sync(KB_FULL, v[j], src);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) y[t + j * nt] = v[j];
}

// sublane rolls: a block takes a [256 rows, 16 lanes] strip of one tile;
// thread t holds lane t % 16 of rows t / 16 + 16 j
template <int STEPS>
__global__ void __launch_bounds__(KB_THREADS)
kb_sublane_roll(const unsigned* __restrict__ x, unsigned* __restrict__ y) {
  constexpr int RSTEP = KB_THREADS / STRIP, RPT = KB_TILE / RSTEP;
  __shared__ unsigned buf[2][KB_TILE][STRIP];
  const long long tile = blockIdx.x / (KB_LANES / STRIP);
  const int col = (blockIdx.x % (KB_LANES / STRIP)) * STRIP;
  const int c = threadIdx.x % STRIP, r0 = threadIdx.x / STRIP;
  const long long off = tile * KB_TILE * KB_LANES + col + c;
  unsigned v[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    v[j] = x[off + (long long)(r0 + j * RSTEP) * KB_LANES];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int p = s & 1;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      buf[p][(r0 + j * RSTEP + 1 + s % 7) & (KB_TILE - 1)][c] = v[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPT; ++j) v[j] = buf[p][r0 + j * RSTEP][c];
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    y[off + (long long)(r0 + j * RSTEP) * KB_LANES] = v[j];
}

// B6's ranking pass: one 256-thread block a row, as seed_pack_rows
template <int STEPS>
__global__ void __launch_bounds__(KB_THREADS)
kb_rank(const unsigned* __restrict__ x, unsigned* __restrict__ y) {
  __shared__ int wcount[KB_THREADS / 32];
  const long long i = (long long)blockIdx.x * KB_LANES + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned u = x[i];
  unsigned acc = 0;
#pragma unroll 4
  for (int s = 0; s < STEPS; ++s) {
    const bool live = (u >> (s % 31)) & 1u;
    const unsigned m = __ballot_sync(KB_FULL, live);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int cnt = lane < KB_THREADS / 32 ? wcount[lane] : 0;
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(KB_FULL, incl, d);
        if (lane >= d) incl += t;
      }
      if (lane < KB_THREADS / 32) wcount[lane] = incl - cnt;
    }
    __syncthreads();
    acc += wcount[warp] + __popc(m & lanemask_lt());
    __syncthreads();                   // wcount is rewritten next step
  }
  y[i] = acc;
}

enum Kind { IDENTITY = 0, ALU, LANE_ROLL, HALF_ROLL, WARP_ROLL, SUBLANE_ROLL,
            RANK, BARRIER, FUNNEL };

template <int STEPS>
void launch(int kind, const void* x, void* y, long long rows,
            cudaStream_t st) {
  const unsigned words4 = static_cast<unsigned>(rows * KB_LANES / 4 /
                                                KB_THREADS);
  const uint4* x4 = static_cast<const uint4*>(x);
  uint4* y4 = static_cast<uint4*>(y);
  const unsigned* xu = static_cast<const unsigned*>(x);
  unsigned* yu = static_cast<unsigned*>(y);
  switch (kind) {
    case ALU: kb_alu<STEPS, false><<<words4, KB_THREADS, 0, st>>>(x4, y4);
      break;
    case BARRIER: kb_alu<STEPS, true><<<words4, KB_THREADS, 0, st>>>(x4, y4);
      break;
    case FUNNEL: kb_funnel<STEPS><<<words4, KB_THREADS, 0, st>>>(x4, y4);
      break;
    case LANE_ROLL:
      kb_lane_roll<STEPS, KB_LANES><<<static_cast<unsigned>(rows / ROWS_PB),
                                      KB_THREADS, 0, st>>>(xu, yu);
      break;
    case HALF_ROLL:
      kb_lane_roll<STEPS, KB_LANES / 2><<<static_cast<unsigned>(
          rows / ROWS_PB), KB_THREADS, 0, st>>>(xu, yu);
      break;
    case WARP_ROLL:
      kb_warp_roll<STEPS><<<words4, KB_THREADS, 0, st>>>(xu, yu);
      break;
    case SUBLANE_ROLL:
      kb_sublane_roll<STEPS><<<static_cast<unsigned>(
          rows / KB_TILE * (KB_LANES / STRIP)), KB_THREADS, 0, st>>>(xu, yu);
      break;
    case RANK:
      kb_rank<STEPS><<<static_cast<unsigned>(rows), KB_THREADS, 0, st>>>(
          xu, yu);
      break;
  }
}

}  // namespace

// One launch of microkernel `kind` with a chain of `steps` (16 or 64; the
// identity takes none) over x[rows, 256] -> y[rows, 256]; rows a multiple
// of 256 (the wrapper checks).
extern "C" int kbench_launch(int kind, int steps, const void* x, void* y,
                             long long rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows % KB_TILE) return cudaErrorInvalidValue;
  if (kind == IDENTITY) {
    kb_identity<<<static_cast<unsigned>(rows * KB_LANES / 4 / KB_THREADS),
                  KB_THREADS, 0, st>>>(static_cast<const uint4*>(x),
                                       static_cast<uint4*>(y));
  } else if (kind < ALU || kind > FUNNEL) {
    return cudaErrorInvalidValue;
  } else if (steps == 16) {
    launch<16>(kind, x, y, rows, st);
  } else if (steps == 64) {
    launch<64>(kind, x, y, rows, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
