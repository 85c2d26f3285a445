// B1: bucket/cell-grid fill of a hash-sorted sample slice.
//
// Replaces sylph_tpu/tpu/bucket_fill.py::_fill_kernel (wrapper
// bucket_fill_pallas), which routes the sorted slice to its [B*nt, CS] cell
// grid through two butterfly networks because the TPU has no cheap scatter.
// Output contract (the plain version is gpu/bucket_join.py::
// _sample_to_buckets): cell = (hash_hi - base) // width, or, tiled,
// bucket*nt + min(((hash_hi - base) % width) // subwidth, nt - 1); a cell
// holds its first CS live (w > 0) entries in slice order; pads are key -1
// and w 0; out-of-range and over-capacity entries are dropped. Unlike the
// Pallas kernel this one never drops an entry for input-window coverage.
//
// Bound on the H100: bytes. The work is one read of the slice's entries in
// range (12 B each) and one write of the grids (NC x CS x 12 B): about 28 MB
// per chunk at GTDB scale, under 10 us at 3.35 TB/s (and all of it fits in
// the 50 MB L2, so a reading near the bound means the data sat there).
//
// Design. The first version ran a warp per output cell: two binary searches
// of about 18 dependent loads each to find a run of about 1.8 entries, then
// 32 lanes for those few entries (0.1578 ms at the grange chunk, 5% of the
// bound). Here a block of 128 threads owns a run of cpb adjacent cells
// (gpu/bucket_fill.py::fill_plan picks cpb from CS and the mean entries a
// cell, P / NC). The slice is sorted, so the block's entries are one
// contiguous range and its output is one contiguous region of the grid:
// - two warps find the range's ends at once, each by a search that probes
//   32 positions a step (about 4 steps, not 18);
// - the block streams the range in tiles of 128 entries, each loaded while
//   the one before is ranked (blocks of 128 threads rather than 256 keep
//   more blocks, and so more of these chains of loads, on a SM); each
//   entry's cell is monotone in the slice, a ballot scan over the tile
//   (carried across tiles) counts the live entries before it, and the
//   first entry of each cell records that count, so an entry's rank among
//   its cell's live entries is the difference, exact under any skew,
//   zero-weight runs included, and O(entries in the range);
// - a live entry of rank < CS goes to its slot of the block's cells, staged
//   in shared memory that starts as pads; then the block writes its whole
//   region, consecutive threads on consecutive 16-byte pieces (scalar
//   stores where the region starts off 16 bytes).
// Every output slot is written exactly once; nothing is atomic.
//
// Measured (chip_smoke.py's "B1_fill" rows, torch.profiler device time on
// an NVIDIA H100 80GB HBM3 at a 700 W power limit): 0.0161 ms at the grange
// chunk (52% of its 0.0084 ms bound; one wave of 1,024 blocks, each a
// chain of search, tile and write), 0.0454 ms on a dense slice (CS 40),
// 0.1211 ms on the bucket regime's whole range (65% of its 0.0791 ms).
// With block_cell's range check added after those readings, kernel_ab's
// synthetic slices read 0.0165-0.0168 ms (grange) and 0.1233-0.1245 ms
// (whole range), against 0.0160-0.0161 and 0.1215-0.1216 before.

#include "common.cuh"

#define FILL_THREADS 128
#define FILL_WARPS (FILL_THREADS / 32)
#define FULL 0xffffffffu
#define SMEM_MAX (232448 - 64)     // 227 KB a block, less its static arrays

namespace {

struct Cells {
  long long base, width, nt, subwidth, NC;
};

// a / b in 32 bits where both fit (the usual case), else in 64
__device__ __forceinline__ unsigned long long udiv(unsigned long long a,
                                                   unsigned long long b) {
  return ((a | b) >> 32) ? a / b
                         : static_cast<unsigned>(a) / static_cast<unsigned>(b);
}

// The least high hash word of cell c (c = NC: one past the last bucket).
__device__ long long cell_floor(const Cells& g, long long c) {
  const long long b = c / g.nt, sub = c - b * g.nt;
  return g.base + b * g.width + (sub ? min(sub * g.subwidth, g.width) : 0);
}

// The cell of a high word at or above base (the plain version's formula).
__device__ __forceinline__ long long cell_of(const Cells& g, long long hi) {
  const unsigned long long off = static_cast<unsigned long long>(hi - g.base);
  const unsigned long long raw = udiv(off, g.width);
  if (g.nt == 1) return static_cast<long long>(raw);
  const unsigned long long sub = udiv(off - raw * g.width, g.subwidth);
  return static_cast<long long>(raw) * g.nt +
         static_cast<long long>(min(sub, (unsigned long long)(g.nt - 1)));
}

// The cell of high word hi among a block's ncell cells from c0, or -1 if it
// lies outside them. On a slice sorted in uint64 order (as the engine
// sorts it; at c = 1 that puts keys of 2^63 and up last) every entry of a
// block's range is one of its cells; a slice out of that order gives wrong
// cells, but never a write past the block's shared memory.
__device__ __forceinline__ int block_cell(const Cells& g, long long hi,
                                          long long c0, int ncell) {
  const long long c = cell_of(g, hi) - c0;
  return c >= 0 && c < ncell ? static_cast<int>(c) : -1;
}

// The first index in [0, n) whose high word is >= q (n if none), by the 32
// lanes of a warp: each step probes 32 evenly spaced positions of the
// interval left and keeps the part between the last probe below q and the
// first at or above it. key_hi is nondecreasing over a sorted, pad-tailed
// slice.
__device__ long long warp_lower_bound(const long long* __restrict__ key,
                                      long long n, long long q, int lane) {
  long long lo = 0, hi = n;           // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const bool ge = key_hi(key[lo + span * (lane + 1) / 33]) >= q;
    const unsigned m = __ballot_sync(FULL, ge);
    const int f = m ? __ffs(m) - 1 : 32;
    const long long nlo = f ? lo + span * f / 33 + 1 : lo;
    if (f < 32) hi = lo + span * (f + 1) / 33;
    lo = nlo;
  }
  const long long pos = lo + lane;
  const unsigned m = __ballot_sync(FULL, pos >= hi || key_hi(key[pos]) >= q);
  return m ? lo + __ffs(m) - 1 : hi;
}

__global__ void __launch_bounds__(FILL_THREADS)
fill_cells_kernel(const long long* __restrict__ key,
                  const int* __restrict__ w, long long P, Cells g, int CS,
                  int cpb, long long* __restrict__ out_k,
                  int* __restrict__ out_w) {
  // staged slots [cpb * CS] (keys, then weights, 16-byte aligned) and the
  // live count before each cell's first entry
  extern __shared__ __align__(16) long long stage_k[];
  const int slots = cpb * CS;
  int* stage_w = reinterpret_cast<int*>(stage_k + ((slots + 1) & ~1));
  long long* run_base =
      reinterpret_cast<long long*>(stage_w + ((slots + 3) & ~3));
  __shared__ long long ends[2];
  __shared__ int wlive[2][FILL_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * cpb;
  const long long c1 = min(c0 + cpb, g.NC);
  const int ncell = static_cast<int>(c1 - c0), nslot = ncell * CS;
  if (warp < 2) {
    const long long r =
        warp_lower_bound(key, P, cell_floor(g, warp ? c1 : c0), lane);
    if (lane == 0) ends[warp] = r;
  }
  for (int i = tid; i < nslot; i += FILL_THREADS) {
    stage_k[i] = KEY_PAD;
    stage_w[i] = 0;
  }
  __syncthreads();
  const long long s = ends[0], e = ends[1];

  long long carry = 0;                // live entries of earlier tiles
  int buf = 0;
  // a thread's entry of each tile, loaded a tile ahead
  long long nk = s + tid < e ? key[s + tid] : KEY_PAD;
  int nw = s + tid < e ? w[s + tid] : 0;
  for (long long t0 = s; t0 < e; t0 += FILL_THREADS) {
    const long long i = t0 + tid;
    const bool valid = i < e;
    const long long k = nk;
    const int wi = nw;
    const bool more = i + FILL_THREADS < e;
    nk = more ? key[i + FILL_THREADS] : KEY_PAD;
    nw = more ? w[i + FILL_THREADS] : 0;
    const int cell = valid ? block_cell(g, key_hi(k), c0, ncell) : -1;
    int prev = __shfl_up_sync(FULL, cell, 1);
    if (lane == 0)
      prev = valid && i > s ? block_cell(g, key_hi(key[i - 1]), c0, ncell)
                            : -1;
    const bool live = cell >= 0 && wi > 0;
    const unsigned m = __ballot_sync(FULL, live);
    if (lane == 0) wlive[buf][warp] = __popc(m);
    __syncthreads();
    long long before = carry;
    int total = 0;
#pragma unroll
    for (int x = 0; x < FILL_WARPS; ++x) {
      const int v = wlive[buf][x];
      total += v;
      before += x < warp ? v : 0;
    }
    before += __popc(m & lanemask_lt());   // live entries before entry i
    if (cell >= 0 && cell != prev) run_base[cell] = before;
    __syncthreads();
    if (live) {
      const long long r = before - run_base[cell];
      if (r < CS) {
        stage_k[cell * CS + r] = k;
        stage_w[cell * CS + r] = wi;
      }
    }
    carry += total;
    buf ^= 1;
  }
  __syncthreads();

  long long* ok = out_k + c0 * CS;
  int* ow = out_w + c0 * CS;
  int x0 = 0;
  if (((c0 * CS) & 3) == 0) {         // 16-byte aligned region
    const int n4 = nslot >> 2;
    for (int q = tid; q < n4; q += FILL_THREADS) {
      const longlong2* sk = reinterpret_cast<const longlong2*>(stage_k);
      longlong2* dk = reinterpret_cast<longlong2*>(ok);
      dk[2 * q] = sk[2 * q];
      dk[2 * q + 1] = sk[2 * q + 1];
      reinterpret_cast<int4*>(ow)[q] =
          reinterpret_cast<const int4*>(stage_w)[q];
    }
    x0 = n4 << 2;
  }
  for (int x = x0 + tid; x < nslot; x += FILL_THREADS) {
    ok[x] = stage_k[x];
    ow[x] = stage_w[x];
  }
}

const void* fill_fn() {
  return reinterpret_cast<const void*>(&fill_cells_kernel);
}

// Dynamic shared memory of a block of cpb cells: the staged keys and
// weights (each run 16-byte aligned) and a live count a cell.
long long smem_need(long long cpb, long long CS) {
  const long long slots = cpb * CS;
  return ((slots + 1) & ~1LL) * 8 + ((slots + 3) & ~3LL) * 4 + cpb * 8;
}

// Opt in to smem bytes of dynamic shared memory where it passes the 48 KB
// every launch may take (on the current device's context).
int allow_smem(long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fill_fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// [NC, CS] grids of a sorted P-entry slice, cpb cells a block
// (gpu/bucket_fill.py::fill_plan's).
extern "C" int fill_cells(const long long* key, const int* w, long long P,
                          long long base, long long width, long long nt,
                          long long subwidth, long long CS, long long NC,
                          long long cpb, long long* out_k, int* out_w,
                          void* stream) {
  const long long smem = CS >= 1 && cpb >= 1 ? smem_need(cpb, CS) : 0;
  if (CS < 1 || cpb < 1 || width < 1 || nt < 1 || subwidth < 1 ||
      smem > SMEM_MAX || (NC + cpb - 1) / cpb >= (1LL << 31) ||
      reinterpret_cast<unsigned long long>(out_k) % 16 ||
      reinterpret_cast<unsigned long long>(out_w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NC == 0) return static_cast<int>(cudaGetLastError());
  int e = allow_smem(smem);
  if (e != 0) return e;
  const Cells g{base, width, nt, subwidth, NC};
  fill_cells_kernel<<<static_cast<unsigned>((NC + cpb - 1) / cpb),
                      FILL_THREADS, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      key, w, P, g, static_cast<int>(CS), static_cast<int>(cpb), out_k,
      out_w);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy of a launch of cpb cells of CS slots a block, as the card
// reports it: registers a thread, shared memory a block (static and
// dynamic), resident blocks a SM and threads a block -> info[0..3].
extern "C" int fill_occupancy(long long cpb, long long CS, int* info) {
  if (CS < 1 || cpb < 1 || smem_need(cpb, CS) > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_need(cpb, CS);
  int e = allow_smem(smem);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, fill_fn()));
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fill_fn(), FILL_THREADS, static_cast<size_t>(smem)));
  if (e != 0) return e;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes + smem);
  info[2] = per_sm;
  info[3] = FILL_THREADS;
  return 0;
}
