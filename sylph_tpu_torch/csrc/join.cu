// B2 / B4 / B5 and their batched forms B2b / B4b / B5b: the grange compare
// kernel, one source in three modes over a sample axis.
//
// Replaces the Pallas bodies over one _block_counts
// (sylph_tpu/tpu/bucket_join.py), single-sample and batched
// (sylph_tpu/tpu/grange.py:_grid_from_buckets_batched,
// _codes_from_buckets_batched, _codes_from_buckets_compact_batched):
//   MODE_COUNTS  _join_kernel                [S, B, CI] int32 weighted counts
//                                            (B5, B5b)
//   MODE_CODES   _join_codes_kernel          [S, B, CI] int32 codes (B4, B4b)
//   MODE_COMPACT _join_codes_compact_kernel  [S, B/TB*CAPR, CI] codes, each
//                column top-packed to CAPR rows per TB-row block, plus the
//                (sample, block)'s pre-compaction live count (B2, B2b)
// For sample s and each index slot (row b, column j) the count is the sum of
// the sample weights dw[s, b, l] over the lanes l visible to column j with
// dk[s, b, l] == key[b, j]. Tiled layout (nt > 1): column j < nt*tile sees
// only lane group j // tile (CS_T = LW / nt lanes); the trailing ov columns
// see every lane. Code = s*G*64 + gid*64 + min(count, 63) where count > 0
// and gid < G, else SENT (-1); the caller keeps S*G*64 + 1 below 2^31. At
// S = 1 the tag is 0 and the modes are B2, B4 and B5 exactly.
//
// Bound on the H100: int64 compares, except on the sparsest slices. Each
// 64-bit equality and its conditional add is three int32 instructions (two
// chained ISETP, one predicated IADD); the card issues 132 SMs x 64 INT32
// lanes x 1.98 GHz = 1.67e13 of them a second. A GTDB-scale chunk
// (B = 32768, CI = 1152) is 453 MB of index (B*CI x 12 B, key + gid),
// 0.14 ms at 3.35 TB/s; a batch of S samples adds S cell grids and S
// outputs but, read once per batch, no more index bytes.
//
// Design: the compares are the work, so each is a shared-memory broadcast
// read plus the three instructions and nothing else: one thread per index
// column of a TB-row block (128 columns per CTA, grid (B/TB, CI/128,
// sample groups)), the index key and gid read once into registers and held
// across the lanes of every sample of the group. The TB rows' lanes of the
// group's samples are staged in shared memory (in groups of rows that fit
// 96 KB) and read as warp broadcasts; the index reads and the output writes
// are coalesced across the warp. A group holds at most MAX_SG samples and
// at most 8,192 lanes of one row; a larger batch takes several groups, each
// re-reading the index. In COMPACT mode the thread keeps a running rank per
// (sample, column) and writes live codes straight to row rank of the
// sample's CAPR-row window of the block, so the uncompacted [TB, CI] block
// never reaches device memory; overflow past CAPR is dropped and shows up in
// the caller's live-count check. Live counts are per-CTA partial sums per
// (sample, block, column group), reduced by the caller: no atomics.

#include "common.cuh"

#define MODE_COUNTS 0
#define MODE_CODES 1
#define MODE_COMPACT 2
#define COLS 128
#define SMEM_BYTES 98304           // dynamic shared memory cap (opt-in)
#define LANES (SMEM_BYTES / 12)    // staged lanes: int64 key + int32 weight
#define MAX_SG 8                   // samples staged together

namespace {

template <int MODE>
__global__ void __launch_bounds__(COLS)
join_kernel(const long long* __restrict__ ikey, const int* __restrict__ gid,
            const long long* __restrict__ dk, const int* __restrict__ dw,
            long long B, long long CI, int LW, int TB, int nt, long long tile,
            int G, int CAPR, int S, int SG, int rps, int* __restrict__ out,
            int* __restrict__ nlive_part) {
  extern __shared__ long long smem[];
  long long* sk = smem;                                     // [sg, nr, LW]
  int* sw = reinterpret_cast<int*>(smem + rps * SG * LW);  // [sg, nr, LW]
  __shared__ int rank_s[MAX_SG * COLS];                    // COMPACT ranks
  __shared__ int red[COLS / 32];

  const long long blk = blockIdx.x;
  const long long nblk = B / TB;
  const int s0 = blockIdx.z * SG;
  const int sg = min(SG, S - s0);
  const long long j = static_cast<long long>(blockIdx.y) * COLS + threadIdx.x;
  const bool col = j < CI;
  int l0 = 0, l1 = LW;
  if (nt > 1 && j < nt * tile) {
    const int cs_t = LW / nt;
    l0 = static_cast<int>(j / tile) * cs_t;
    l1 = l0 + cs_t;
  }
  if (MODE == MODE_COMPACT) {
    for (int s = 0; s < sg; ++s) rank_s[s * COLS + threadIdx.x] = 0;
  }
  for (int r0 = 0; r0 < TB; r0 += rps) {
    const int nr = min(rps, TB - r0);
    __syncthreads();
    // the nr rows of one sample are contiguous in its [B, LW] grid
    for (int s = 0; s < sg; ++s) {
      const long long src = ((s0 + s) * B + blk * TB + r0) * LW;
      long long* dst_k = sk + s * nr * LW;
      int* dst_w = sw + s * nr * LW;
      for (int x = threadIdx.x; x < nr * LW; x += COLS) {
        dst_k[x] = dk[src + x];
        dst_w[x] = dw[src + x];
      }
    }
    __syncthreads();
    if (!col) continue;
    for (int rr = 0; rr < nr; ++rr) {
      const long long row = blk * TB + r0 + rr;
      const long long a = ikey[row * CI + j];
      const int g = MODE == MODE_COUNTS ? 0 : gid[row * CI + j];
      for (int s = 0; s < sg; ++s) {
        const long long* lk = sk + (s * nr + rr) * LW;
        const int* lw = sw + (s * nr + rr) * LW;
        int cnt = 0;
#pragma unroll 4
        for (int l = l0; l < l1; ++l) {
          if (lk[l] == a) cnt += lw[l];
        }
        const long long so = s0 + s;
        if (MODE == MODE_COUNTS) {
          out[(so * B + row) * CI + j] = cnt;
          continue;
        }
        const bool live = cnt > 0 && g < G;
        const int code =
            live ? static_cast<int>(so * G * HIST_H) + g * HIST_H +
                       min(cnt, HIST_H - 1)
                 : CODE_SENT;
        if (MODE == MODE_CODES) {
          out[(so * B + row) * CI + j] = code;
        } else {
          int& rank = rank_s[s * COLS + threadIdx.x];
          if (live && rank < CAPR)
            out[((so * nblk + blk) * CAPR + rank) * CI + j] = code;
          rank += live;
        }
      }
    }
  }
  if (MODE == MODE_COMPACT) {
    for (int s = 0; s < sg; ++s) {
      const long long so = s0 + s;
      // a column's final rank is its live count over the TB rows
      int nl = col ? rank_s[s * COLS + threadIdx.x] : 0;
      if (col) {
        for (int r = min(nl, CAPR); r < CAPR; ++r)
          out[((so * nblk + blk) * CAPR + r) * CI + j] = CODE_SENT;
      }
      for (int o = 16; o > 0; o >>= 1)
        nl += __shfl_down_sync(0xffffffffu, nl, o);
      __syncthreads();                  // red[] of the previous sample read
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = nl;
      __syncthreads();
      if (threadIdx.x == 0) {
        int tot = 0;
        for (int i = 0; i < COLS / 32; ++i) tot += red[i];
        nlive_part[(so * nblk + blk) * gridDim.y + blockIdx.y] = tot;
      }
    }
  }
}

// Opts in to SMEM_BYTES of dynamic shared memory before every launch. The
// 48 KB default counts the static arrays too, so a 48 KB stage already
// needs it; and the attribute belongs to the current device's context, so
// it is not set once per process.
template <int MODE>
int launch_mode(dim3 grid, size_t smem, cudaStream_t st,
                const long long* ikey, const int* gid, const long long* dk,
                const int* dw, long long B, long long CI, int lw, int tb,
                int n, long long tile, int g, int capr, int S, int SG, int r,
                int* out, int* nlive_part) {
  const cudaError_t e = cudaFuncSetAttribute(
      join_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  join_kernel<MODE><<<grid, COLS, smem, st>>>(
      ikey, gid, dk, dw, B, CI, lw, tb, n, tile, g, capr, S, SG, r, out,
      nlive_part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S samples' [S, B, LW] cell grids against one [B, CI] index chunk. Samples
// are staged SG at a time (at most MAX_SG, and at most LANES lanes of one
// row), rows rps at a time within a group.
extern "C" int join_launch(int mode, const long long* ikey, const int* gid,
                           const long long* dk, const int* dw, long long S,
                           long long B, long long CI, long long LW,
                           long long TB, long long nt, long long tile,
                           long long G, long long CAPR, int* out,
                           int* nlive_part, void* stream) {
  if (LW < 1 || LW > LANES || TB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long SG = LANES / LW;
  if (SG > MAX_SG) SG = MAX_SG;
  if (SG > S) SG = S;
  if (SG < 1) return static_cast<int>(cudaGetLastError());   // S == 0
  long long rps = LANES / (SG * LW);
  if (rps > TB) rps = TB;
  const dim3 grid(static_cast<unsigned>(B / TB),
                  static_cast<unsigned>((CI + COLS - 1) / COLS),
                  static_cast<unsigned>((S + SG - 1) / SG));
  const size_t smem = static_cast<size_t>(rps * SG * LW * 12);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lw = static_cast<int>(LW), tb = static_cast<int>(TB);
  const int n = static_cast<int>(nt), g = static_cast<int>(G);
  const int capr = static_cast<int>(CAPR), r = static_cast<int>(rps);
  const int s = static_cast<int>(S), sg = static_cast<int>(SG);
  if (grid.x == 0 || grid.y == 0) return static_cast<int>(cudaGetLastError());
  if (mode == MODE_COUNTS)
    return launch_mode<MODE_COUNTS>(grid, smem, st, ikey, gid, dk, dw, B, CI,
                                    lw, tb, n, tile, g, capr, s, sg, r, out,
                                    nlive_part);
  if (mode == MODE_CODES)
    return launch_mode<MODE_CODES>(grid, smem, st, ikey, gid, dk, dw, B, CI,
                                   lw, tb, n, tile, g, capr, s, sg, r, out,
                                   nlive_part);
  return launch_mode<MODE_COMPACT>(grid, smem, st, ikey, gid, dk, dw, B, CI,
                                   lw, tb, n, tile, g, capr, s, sg, r, out,
                                   nlive_part);
}
