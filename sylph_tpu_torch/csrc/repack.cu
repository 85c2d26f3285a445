// B3 and B8: windowed, order-preserving stream compaction of a pad-coded
// stream (pad -1).
//
// Replaces sylph_tpu/tpu/bucket_fill.py::_repack1_flat_kernel (wrapper
// repack1_flat, int32 gid*64+mult codes, SENT -1) and
// ::_repack2_flat_kernel (wrapper repack2_flat, the (hi, lo) uint32 pair
// streams of read seeding, which are one int64 key here with pad -1), both
// of which condense each row-slot window with an LSB-first butterfly over
// [row/256, 256] tiles. Output contract: the stream is read as nwin windows
// of row slots (B3 and B8: nwin = 8 * ceil(n / (8 * row))), slots past n
// read as pad; window w's live (non-pad) entries, in order, fill
// out[w*cap : w*cap + cap]; entries past cap are dropped (callers check
// conservation) and the rest of the window's output is -1. The two Pallas
// bodies are one algorithm on two payloads, so one kernel template serves
// both.
//
// It also serves B11 and B12, the row repacks of pallas_seeding.py
// (::_repack_kernel, wrapper repack_pallas, on (hi, lo) pairs: the int64
// instance; ::_repack1_kernel, wrapper repack1_pallas, on uint32 codes: the
// int32 instance). Their contract is this one with windows called rows and
// nwin = the row count padded to a multiple of the Pallas row block, which
// the wrappers in sylph_tpu_torch/gpu/seeding.py compute; row and cap are
// multiples of 128 there, which the kernel takes as it takes any width.
//
// Bound on the H100: bytes. One read of the stream (n slots) and one write
// of nwin*cap slots (4 B a slot for B3, 8 B for B8): 18.2 MB for B8 at a
// [65,536, 256] read batch (5.4 us at 3.35 TB/s), 76 MB for B3 at a
// GTDB-scale chunk's code stream (23 us), as chip_smoke.py measures them.
//
// Design. The first version gave each window one block of 1,024 threads
// that took 1,024 slots a pass: one load a thread, a ballot, a warp-0 scan
// and three barriers, then the next pass. A pass waited out a whole
// device-memory latency with 4-8 KB in flight, so a window of 32,768 int64
// keys was 32 such waits in a row (B8 0.0212 ms against its 0.0054 ms
// bound). Here:
// - A window is split over a thread-block cluster of C CTAs (a power of two
//   up to 8), each of which stages one piece of L slots (at most 32 KB;
//   gpu/bucket_fill.py::repack_plan picks C and L) by TMA bulk copies into
//   shared memory: each warp copies its own eighth of the piece and waits
//   on its own mbarrier, so the whole window is in flight at once, no
//   register holds a byte of it, and a warp starts as soon as its bytes
//   land. A window wider than 8 pieces is taken in rounds of C pieces.
// - Each warp then moves its run's live entries, in order, to the run's
//   front in place (ballots rank them; a step of 32 chunks with no live
//   entry costs one vote), so the piece is read from shared memory once.
// - One barrier publishes the warp counts; the CTAs of a cluster exchange
//   their piece counts through distributed shared memory behind one
//   cluster barrier, so each knows where its run starts in the window's
//   output and the window's count so far. A full window stops reading at
//   the next round.
// - A CTA writes its run of the window's output with 16-byte stores
//   (single slots only at the run's two ends), gathering each slot from its
//   warp's run, and the cluster writes the -1 tail after the last round
//   with 16-byte stores, split over its CTAs. Every output slot is written
//   once; nothing is atomic, and no state outlives a cluster.
// - At most 32 KB a CTA and a launch bound of 5 CTAs a SM (48 registers at
//   most) keep every cluster of B8's one-wave launch resident at once.
// The slots past n of the last piece are never read. Where the stream is
// not 16-byte aligned (a view into another tensor), the CTA loads its piece
// from device memory slot by slot instead of by bulk copy.
//
// Measured (kernel_ab's "B3 grange" and "B8 reads" cases at chip_smoke.py's
// shapes, torch.profiler device time on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit): B3 0.0332-0.0339 ms (14.2M int32 slots, row 8,192, cap
// 2,816: one CTA a window, 1,728 CTAs, 5 resident a SM), B8 0.0077 ms
// (2.16M int64 slots, row 32,768, cap 1,536: clusters of 8, 576 CTAs in one
// wave), against 0.0684 and 0.0212 ms for the first version in the same
// call. Trial builds lost: one copy a CTA instead of one a warp (B3 a tie,
// B8 0.0088), pieces of 16 KB (B3 0.0379, B8 0.0092); on earlier trial
// shapes (18.9M int32 slots at row 32,768, 2.2M int64 at row 16,384), a
// stage for the ranked entries with two passes over the piece (B3 0.0364,
// B8 0.0100, against 0.0330 and 0.0086 for one copy a CTA in the same
// call), and that with a persistent grid keeping two pieces in flight a
// CTA (0.0420 and 0.0108, against 0.0374 and 0.0100 without it). This
// design on a persistent grid, the resident clusters looping over windows
// with the next window's pieces in flight, lost too (B3 0.0350, B8 0.0106).

#include <cooperative_groups.h>

#include "common.cuh"

#define RP_THREADS 256
#define RP_WARPS (RP_THREADS / 32)
#define RP_MIN_CTAS 5               // resident CTAs a SM, at least
#define RP_CLUSTER_MAX 8
#define RP_PIECE_BYTES 32768        // bytes a CTA stages, at most
#define FULL 0xffffffffu

namespace cg = cooperative_groups;

namespace {

struct Geo {
  long long n, row, cap;
  int piece;      // L: slots a CTA stages a round (a multiple of 128)
  int rounds;     // ceil(row / (C * L))
};

template <typename T>
union Chunk {                        // 16 bytes: 4 int32 or 2 int64
  int4 raw;
  T e[16 / sizeof(T)];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this CTA's shared memory, completing on
// the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Chunk q (16 bytes) of the current piece: from shared memory where the
// bulk copy brought it, else from device memory slot by slot (the piece's
// last, partial chunk at the end of the stream, or a stream off 16 bytes);
// pad past the piece's nv valid slots or where the chunk is not the warp's.
template <typename T>
__device__ __forceinline__ Chunk<T> piece_chunk(const T* buf, const T* src,
                                                int q, bool mine, int nbulk,
                                                int nv) {
  constexpr int V = 16 / sizeof(T);
  Chunk<T> c;
  if (mine && q < nbulk) {
    c.raw = reinterpret_cast<const int4*>(buf)[q];
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int i = q * V + e;
      c.e[e] = mine && i < nv ? src[i] : static_cast<T>(-1);
    }
  }
  return c;
}

template <typename T>
__global__ void __launch_bounds__(RP_THREADS, RP_MIN_CTAS)
repack_kernel(const T* __restrict__ v, Geo g, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);       // the piece, g.piece slots
  __shared__ __align__(8) unsigned long long bar[RP_WARPS];
  __shared__ int wcnt[RP_WARPS];             // live entries a warp
  __shared__ int cnt[2];                     // the piece's, by round parity

  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const long long win = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T pad = static_cast<T>(-1);
  const bool bulk = (reinterpret_cast<unsigned long long>(v) & 15) == 0;
  const unsigned bar_a = smem_u32(&bar[warp]);
  if (lane == 0) mbar_init(bar_a, 1);
  __syncwarp();

  T* o = out + win * g.cap;
  const int QL = g.piece / V;                          // chunks a piece
  const int QW = (QL + RP_WARPS - 1) / RP_WARPS;       // chunks a warp
  const unsigned lt = lanemask_lt();
  unsigned phase = 0;
  long long base = 0;                  // the window's live entries so far
  for (int r = 0; r < g.rounds; ++r) {
    const long long off = (static_cast<long long>(r) * C + rank) * g.piece;
    const long long gs = win * g.row + off;
    const long long len =
        min(min(static_cast<long long>(g.piece), g.row - off), g.n - gs);
    const int nv = len > 0 ? static_cast<int>(len) : 0;
    const int nbulk = bulk ? nv / V : 0;   // chunks the bulk copy brings
    const T* src = v + gs;
    // each warp stages its own run of the piece's chunks by one bulk copy
    // and waits for that copy only
    const int q0 = min(warp * QW, QL), q1 = min(q0 + QW, QL);
    const int wbulk = min(q1, nbulk) - q0;
    if (wbulk > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_a, wbulk * 16u);
        bulk_load(smem_u32(buf + q0 * V), src + q0 * V, wbulk * 16u, bar_a);
      }
      mbar_wait(bar_a, phase);
      phase ^= 1;
    }
    // then moves the run's live entries, in order, to the run's front (in
    // place: an entry's rank is at most its position, and a step's chunks
    // are all read before any is written); a step whose 32 chunks are all
    // pad costs one vote
    T* wbuf = buf + q0 * V;
    int mine = 0;
    for (int s = q0; s < q1; s += 32) {
      const int q = s + lane;
      const Chunk<T> c = piece_chunk(buf, src, q, q < q1, nbulk, nv);
      bool any = false;
#pragma unroll
      for (int e = 0; e < V; ++e) any |= c.e[e] != pad;
      if (!__any_sync(FULL, any)) continue;
      unsigned m[V];
      int rk = mine;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        m[e] = __ballot_sync(FULL, c.e[e] != pad);
        rk += __popc(m[e] & lt);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (c.e[e] != pad) wbuf[rk++] = c.e[e];
        mine += __popc(m[e]);
      }
    }
    if (lane == 0) wcnt[warp] = mine;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int x = 0; x < RP_WARPS; ++x) total += wcnt[x];
    if (tid == 0) cnt[r & 1] = total;
    cluster_arrive();                  // runs and counts complete
    cluster_wait();

    // the cluster's piece counts: where this CTA's run starts, and the
    // round's total
    const int k = lane < C ? *cl.map_shared_rank(&cnt[r & 1], lane) : 0;
    const long long o0 = base + __reduce_add_sync(FULL, lane < rank ? k : 0);
    base += __reduce_add_sync(FULL, k);
    const bool last = r + 1 == g.rounds || base >= g.cap;
    if (last) cluster_arrive();        // done with the others' counts
    // the run's entry j is entry j - (warps before x) of warp x's run
    const long long o1 = min(o0 + total, g.cap);
    for (long long q = o0 / V + tid; q * V < o1; q += RP_THREADS) {
      const long long s0 = q * V;
      Chunk<T> c;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = static_cast<int>(s0 + e - o0);
        int x = 0, before = 0, acc = 0;
#pragma unroll
        for (int t = 0; t < RP_WARPS - 1; ++t) {
          acc += wcnt[t];
          if (j >= acc) {
            x = t + 1;
            before = acc;
          }
        }
        c.e[e] = j >= 0 && s0 + e < o1 ? buf[min(x * QW, QL) * V + j - before]
                                       : pad;
      }
      if (s0 >= o0 && s0 + V <= o1) {
        *reinterpret_cast<int4*>(o + s0) = c.raw;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (s0 + e >= o0 && s0 + e < o1) o[s0 + e] = c.e[e];
      }
    }
    if (last) break;
    // the next round's bulk copy overwrites buf, which this one wrote
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                   // buf and wcnt are reused
  }

  // the -1 tail [min(base, cap), cap), 16 bytes a store, over the cluster
  const long long tz = min(base, g.cap);
  Chunk<T> pads;
#pragma unroll
  for (int e = 0; e < V; ++e) pads.e[e] = pad;
  for (long long q = tz / V + rank * RP_THREADS + tid; q * V < g.cap;
       q += static_cast<long long>(C) * RP_THREADS) {
    const long long s0 = q * V;
    if (s0 >= tz) {
      *reinterpret_cast<int4*>(o + s0) = pads.raw;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (s0 + e >= tz) o[s0 + e] = pad;
    }
  }
  cluster_wait();                      // no CTA leaves while its counts
}                                      // may still be read

// Dynamic shared memory of a CTA: its piece, at most 32 KB, under the 48
// KB any launch may take without opting in.
long long smem_need(long long piece, int width) { return piece * width; }

bool bad_plan(long long row, long long cap, long long C, long long piece,
              int width) {
  return row < 128 || row % 128 || cap < 0 || cap % 128 || cap > row ||
         C < 1 || C > RP_CLUSTER_MAX || (C & (C - 1)) || piece < 128 ||
         piece % 128 || piece * width > RP_PIECE_BYTES;
}

// The launch configuration of `clusters` clusters of C CTAs.
cudaLaunchConfig_t cluster_config(long long clusters, long long C,
                                  long long smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * C));
  cfg.blockDim = dim3(RP_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(C);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(const T* v, long long n, long long row, long long cap,
           long long nwin, long long C, long long piece, T* out,
           void* stream) {
  const int width = static_cast<int>(sizeof(T));
  if (n < 0 || nwin < 0 || bad_plan(row, cap, C, piece, width) ||
      nwin * C >= (1LL << 31) ||
      reinterpret_cast<unsigned long long>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nwin == 0 || cap == 0) return static_cast<int>(cudaGetLastError());
  const long long smem = smem_need(piece, width);
  const Geo g{n, row, cap, static_cast<int>(piece),
              static_cast<int>((row + C * piece - 1) / (C * piece))};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(nwin, C, smem, stream, &attr);
  const int e =
      static_cast<int>(cudaLaunchKernelEx(&cfg, repack_kernel<T>, v, g, out));
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(long long row, long long cap, long long C, long long piece,
              int* info) {
  if (bad_plan(row, cap, C, piece, static_cast<int>(sizeof(T))))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_need(piece, static_cast<int>(sizeof(T)));
  cudaFuncAttributes attr;
  int e = static_cast<int>(cudaFuncGetAttributes(&attr, repack_kernel<T>));
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, repack_kernel<T>, RP_THREADS, static_cast<size_t>(smem)));
  if (e != 0) return e;
  cudaLaunchAttribute ca;
  const cudaLaunchConfig_t cfg = cluster_config(1, C, smem, nullptr, &ca);
  int clusters = 0;
  e = static_cast<int>(
      cudaOccupancyMaxActiveClusters(&clusters, repack_kernel<T>, &cfg));
  if (e != 0) return e;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes + smem);
  info[2] = per_sm;
  info[3] = RP_THREADS;
  info[4] = clusters;
  return 0;
}

}  // namespace

// B3 and B12: int32 code streams (SENT = -1). C CTAs a window (a cluster)
// and piece slots a CTA: gpu/bucket_fill.py::repack_plan's.
extern "C" int repack_launch(const int* v, long long n, long long row,
                             long long cap, long long nwin, long long C,
                             long long piece, int* out, void* stream) {
  return launch<int>(v, n, row, cap, nwin, C, piece, out, stream);
}

// B8 and B11: int64 hash-key streams (pad = -1)
extern "C" int repack64_launch(const long long* v, long long n,
                               long long row, long long cap, long long nwin,
                               long long C, long long piece, long long* out,
                               void* stream) {
  return launch<long long>(v, n, row, cap, nwin, C, piece, out, stream);
}

// The occupancy of a launch (width 4 or 8 bytes a slot) at this plan, as
// the card reports it: registers a thread, shared memory a CTA (static and
// dynamic), resident CTAs a SM, threads a CTA and clusters of C CTAs
// resident on the card at once -> info[0..4].
extern "C" int repack_occupancy(int width, long long row, long long cap,
                                long long C, long long piece, int* info) {
  if (width == 4) return occupancy<int>(row, cap, C, piece, info);
  if (width == 8) return occupancy<long long>(row, cap, C, piece, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
