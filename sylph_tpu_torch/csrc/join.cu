// B2 / B4 / B5 and their batched forms B2b / B4b / B5b (and B5', B5's kernel
// at the bucket regime's layout): the grange compare kernel, one source in
// three modes over a sample axis.
//
// Replaces the Pallas bodies over one _block_counts
// (sylph_tpu/tpu/bucket_join.py), single-sample and batched
// (sylph_tpu/tpu/grange.py:_grid_from_buckets_batched,
// _codes_from_buckets_batched, _codes_from_buckets_compact_batched):
//   MODE_COUNTS  _join_kernel                [S, B, CI] int32 weighted counts
//                                            (B5, B5', B5b)
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
// Bound on the H100: the bytes, except where a sample is dense. The data
// needs the key grid once (B*CI x 8 B), the weight grid (S*B*LW x 4 B), 8 B
// for each live lane's key, 4 B of gid for each slot whose count is > 0
// (code modes) and the output as written; at a GTDB-scale chunk (B = 32768,
// CI = 1152) that is about 0.37 GB for B2 (0.11 ms at 3.35 TB/s) and 0.48
// GB for B4 (0.145 ms). The compares it needs are the live slots times the
// live lanes they meet, three int32 instructions each (two chained ISETP
// on the ALU pipe, 64 lanes a clock an SM, and one predicated add on
// either pipe; chip_smoke.py's COMPARE_CLOCKS) at 132 SMs x 1.98 GHz.
//
// Design. A CTA of 64 threads owns 128 adjacent columns of one TB-row block,
// two adjacent columns a thread (one 16-byte key load a row). The CTAs of
// the last column group of every block (the overflow columns at the main
// path's shapes, the heaviest) are scheduled first; then the others block
// by block, so that the CTAs of one block run together and share its lanes
// in L2; grid z runs over the sample groups. About 13 KB of shared memory a
// CTA lets 16 CTAs (32 warps) reside on a SM at the main path's shapes.
// - Staging: only the lane groups the CTA's columns see, R rows at a time
//   (R = lanes a buffer holds / lanes staged a row), into a ring of two
//   shared-memory buffers by cp.async: stage k+1 is in flight while stage k
//   is compacted and compared. A CTA whose columns all lie past the tiles
//   (or nt == 1) keeps one list of every lane a row, the others a list per
//   lane group, each list an even number of slots.
// - Compaction: each warp compacts in place the (sample, row) lists it
//   copied: the lanes of non-zero weight, their count, a zero weight after
//   an odd count; a flag records whether a live lane of the row holds the
//   pad key -1. A zero-weight lane adds nothing to any count, so this is
//   exact for any input.
// - Compare: a thread loops over the live lanes its columns see; with tile
//   a multiple of 64 the loop bound is warp-uniform. Two keys come in one
//   16-byte broadcast load from shared memory, serve both columns and are
//   compared by their low words; the high words and the weights are tested
//   only where a low word matches. A slot with the pad key is compared only
//   where the row's flag is set, since it can match nothing else: whole
//   warps of empty overflow columns skip their rows.
// - Index keys are loaded up to three rows ahead (streaming loads) into a
//   ring of register slots; the row loop is unrolled over the slots, so that
//   a slot is never moved and its load is waited for only where its row is
//   compared. The code modes read a slot's gid only where its count is > 0.
// - COMPACT keeps a running rank per (sample, column) and writes each live
//   code straight to row rank of the sample's CAPR-row window of the block,
//   so the uncompacted [TB, CI] block never reaches device memory; overflow
//   past CAPR is dropped and shows in the caller's live-count check. Live
//   counts are per-CTA partial sums per (sample, block, column group),
//   reduced by the caller: no atomics.
// The launch takes an even CI, an even tile (so a thread's two columns
// see the same lane lists) and a 16-byte aligned key grid; the wrapper
// raises on any other. The launch plan (samples a group, lanes a buffer,
// shared memory) is the wrapper's (gpu/bucket_join.py::join_plan); the
// kernel derives R and the staged lists from it.

#include "common.cuh"

#define MODE_COUNTS 0
#define MODE_CODES 1
#define MODE_COMPACT 2
#define CPT 2                      // index columns a thread
#define THREADS 64                 // threads a CTA
#define NWARPS (THREADS / 32)
#define COLS (CPT * THREADS)       // index columns a CTA
#define MAX_SG 8                   // samples staged together
#define MIN_CTAS 16                // resident CTAs a SM aimed at: 32 warps
#define AHEAD 2                    // index rows loaded ahead of the compare
#define SMEM_MAX 232448            // 227 KB, the most a CTA may ask for

namespace {

struct JoinArgs {
  const long long* ikey;
  const int* gid;
  const long long* dk;
  const int* dw;
  int* out;
  int* nlive_part;
  long long B, CI;
  int LW, TB, nt, tile, G, CAPR, S, SG, lane_buf, list_cap;
};

struct Keys {
  long long k[CPT];
};

// The "memory" clobbers keep the compiler from moving shared-memory
// accesses across the copies and the wait.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static_assert(CPT == 2, "a thread's keys are one 16-byte load");

// A thread's index keys in one row, one 16-byte load; KEY_PAD where its
// columns lie past CI (nc == 0).
__device__ __forceinline__ Keys load_keys(const long long* p, int nc) {
  Keys r;
  if (nc == CPT) {
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(p));
    r.k[0] = v.x;
    r.k[1] = v.y;
  } else {
    r.k[0] = r.k[1] = KEY_PAD;
  }
  return r;
}

// One row of a thread's output values, 4 bytes at a time: a build that
// stored the pair as one 8-byte vector once left cells of a CTA's first
// thread wrong; the cause is not known (ROADMAP.md, C).
__device__ __forceinline__ void store_row(int* p, int nc, const int* v) {
  if (nc == CPT) {
    p[0] = v[0];
    p[1] = v[1];
  }
}

// Weighted matches of a thread's CPT keys (low words alo, high words ahi)
// against a lane list of n2 lanes (even; a lane past the live ones weighs
// 0): two keys a 16-byte load, compared by their low words, the high words
// and weights checked only where a low word matches.
__device__ __forceinline__ void count_list(const long long* k, const int* w,
                                           int n2, const int* alo,
                                           const int* ahi, int* cnt) {
#pragma unroll 2
  for (int i = 0; i < n2; i += 2) {
    const int4 x = *reinterpret_cast<const int4*>(k + i);  // lo, hi, lo, hi
    bool m = false;
#pragma unroll
    for (int c = 0; c < CPT; ++c) m |= (x.x == alo[c]) | (x.z == alo[c]);
    if (m) {
      const int2 y = *reinterpret_cast<const int2*>(w + i);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        cnt[c] += x.x == alo[c] && x.y == ahi[c] ? y.x : 0;
        cnt[c] += x.z == alo[c] && x.w == ahi[c] ? y.y : 0;
      }
    }
  }
}

__device__ __forceinline__ int code_of(int cnt, int g, int tag, int G) {
  return cnt > 0 && g < G ? tag + g * HIST_H + min(cnt, HIST_H - 1)
                          : CODE_SENT;
}

// MULTI: the launch stages several samples together (SG > 1); otherwise
// the sample loop is one iteration the compiler folds away and the ranks
// of COMPACT live in registers.
template <int MODE, bool MULTI>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
join_kernel(const JoinArgs p) {
  // per ring buffer: the staged lanes' keys and weights, in lane lists
  // of an even number of slots
  extern __shared__ __align__(16) long long skey[];  // [2][lane_buf]
  int* swt = reinterpret_cast<int*>(skey + 2 * p.lane_buf);  // [2][lane_buf]
  int* scnt = swt + 2 * p.lane_buf;                 // [2][list_cap]
  int* sneg = scnt + 2 * p.list_cap;                // [2][list_cap]
  int* srank = sneg + 2 * p.list_cap;               // [SG][COLS]
  __shared__ int red[MAX_SG * NWARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncg = static_cast<int>((p.CI + COLS - 1) / COLS);
  const long long nblk = p.B / p.TB;
  // the column groups past the tiles (the heaviest CTAs) come first
  long long blk = blockIdx.x;
  int cg = ncg - 1;
  if (blk >= nblk) {
    blk -= nblk;
    cg = static_cast<int>(blk % (ncg - 1));
    blk /= ncg - 1;
  }
  const int s0 = blockIdx.z * p.SG;
  const int sg = MULTI ? min(p.SG, p.S - s0) : 1;
  const int TB = p.TB, nt = p.nt, cs_t = p.LW / nt, G = p.G;
  const int CI = static_cast<int>(p.CI);   // TB * CI < 2^31 (launcher)
  const int c0 = cg * COLS, j0 = c0 + CPT * tid;
  const int nc = j0 < CI ? CPT : 0;  // this thread's live columns (CI even)
  // columns in the tiles; past them (and at nt == 1) a column sees all
  const int tiled = nt > 1 ? nt * p.tile : 0;
  const int cl = min(c0 + COLS, CI) - 1;
  int gA = 0, gB = nt;              // lane groups this CTA stages
  if (cl < tiled) {
    gA = c0 / p.tile;
    gB = cl / p.tile + 1;
  }
  // lane lists a staged row: one per group, or one of every lane where
  // every column of the CTA sees every lane
  const bool merged = c0 >= tiled;
  const int ng = gB - gA, nlist = merged ? 1 : ng;
  const int lcs = merged ? p.LW : cs_t, lcs_p = (lcs + 1) & ~1;
  const int span_p = nlist * lcs_p;
  const int R = min(TB, p.lane_buf / (sg * span_p));
  const int nst = (TB + R - 1) / R;
  // the lists [la, lb) both columns of the thread see (tile even)
  const int la = j0 < tiled ? j0 / p.tile - gA : 0;
  const int lb = j0 < tiled ? la + 1 : nlist;
  // this CTA's first row (and sample) of each grid, at its first column
  const long long row0 = blk * TB;
  const long long* ik = p.ikey + row0 * CI + j0;
  const int* gp = p.gid + row0 * CI + j0;
  const long long ostride =
      MODE == MODE_COMPACT ? nblk * p.CAPR * CI : p.B * CI;   // a sample
  int* op = p.out + s0 * ostride +
            (MODE == MODE_COMPACT ? blk * p.CAPR : row0) * CI + j0;

  int rank[CPT];                    // COMPACT ranks of sample s0 (!MULTI)
#pragma unroll
  for (int c = 0; c < CPT; ++c) rank[c] = 0;
  if (MODE == MODE_COMPACT && MULTI) {
    for (int s = 0; s < sg; ++s)
#pragma unroll
      for (int c = 0; c < CPT; ++c) srank[s * COLS + CPT * tid + c] = 0;
  }

  // stage st's rows of every sample of the group into buffer b: warp w
  // copies the (sample, row) lists q = w, w + NWARPS, ... and later
  // compacts the same lists, so a copy needs only its own warp's wait
  auto fetch = [&](int st, int b) {
    const int r0 = st * R, nr = min(R, TB - r0);
    const int span = ng * cs_t;
    for (int q = warp; q < sg * nr; q += NWARPS) {
      const int s = q / nr, rr = q - s * nr;
      const long long src =
          ((s0 + s) * p.B + row0 + r0 + rr) * p.LW + gA * cs_t;
      const int d = b * p.lane_buf + q * span_p;
      for (int x = lane; x < span; x += 32) {
        const int l = merged || ng == 1 ? x : x / cs_t * lcs_p + x % cs_t;
        cp_async<8>(skey + d + l, p.dk + src + x);
        cp_async<4>(swt + d + l, p.dw + src + x);
      }
    }
    cp_async_commit();
  };

  // in place, per (sample, row, list): the lanes of non-zero weight
  // first, their count, a zero weight after an odd count; and per (sample,
  // row) whether a live lane holds the pad key
  auto compact = [&](int st, int b) {
    const int nr = min(R, TB - st * R);
    for (int q = warp; q < sg * nr; q += NWARPS) {
      unsigned neg = 0;
      for (int g = 0; g < nlist; ++g) {
        const int base = b * p.lane_buf + q * span_p + g * lcs_p;
        int n = 0;
        for (int c = 0; c < lcs; c += 32) {
          long long x = KEY_PAD;
          int y = 0;
          if (c + lane < lcs) {
            x = skey[base + c + lane];
            y = swt[base + c + lane];
          }
          const unsigned m = __ballot_sync(0xffffffffu, y != 0);
          neg |= __ballot_sync(0xffffffffu, y != 0 && x == KEY_PAD);
          __syncwarp();           // every read of this chunk before a write
          if (y != 0) {
            const int pos = base + n + __popc(m & lanemask_lt());
            skey[pos] = x;
            swt[pos] = y;
          }
          n += __popc(m);
        }
        __syncwarp();
        // every lane stores the same warp-uniform values
        if (n & 1) swt[base + n] = 0;
        scnt[b * p.list_cap + q * nlist + g] = n;
      }
      sneg[b * p.list_cap + q] = neg != 0;
    }
  };

  // row r (row rr of stage buffer b): counts of every sample, then the
  // output row (COMPACT: each live code at its column's rank)
  auto row = [&](int r, int rr, int nr, int b, const Keys& a) {
    int alo[CPT], ahi[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      alo[c] = static_cast<int>(a.k[c]);
      ahi[c] = static_cast<int>(a.k[c] >> 32);
    }
    for (int s = 0; s < sg; ++s) {
      const int q = s * nr + rr;
      const int o = b * p.lane_buf + q * span_p;
      const int* nq = scnt + b * p.list_cap + q * nlist;
      const bool neg = sneg[b * p.list_cap + q] != 0;
      bool any = false;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        any = any || (c < nc && (a.k[c] != KEY_PAD || neg));
      int cnt[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) cnt[c] = 0;
      if (any)
        for (int g = la; g < lb; ++g) {
          const int l = o + g * lcs_p;
          count_list(skey + l, swt + l, (nq[g] + 1) & ~1, alo, ahi, cnt);
        }
      int* os = op + s * ostride;
      if (MODE == MODE_COUNTS) {
        store_row(os + r * CI, nc, cnt);
        continue;
      }
      // the gid of a slot is read only where its count is > 0
      const int tag = (s0 + s) * G * HIST_H;
      int code[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        code[c] = code_of(cnt[c],
                          c < nc && cnt[c] > 0 ? __ldcs(gp + r * CI + c) : G,
                          tag, G);
      if (MODE == MODE_CODES) {
        store_row(os + r * CI, nc, code);
        continue;
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (code[c] == CODE_SENT) continue;
        int& rk = MULTI ? srank[s * COLS + CPT * tid + c] : rank[c];
        if (rk < p.CAPR) os[rk * CI + c] = code[c];
        ++rk;
      }
    }
  };

  // index keys of rows r .. r + AHEAD, row r in slot r % (AHEAD + 1): the
  // row loop is unrolled over the slots so that a slot stays in its
  // registers and its load is waited for only where the row is compared
  Keys slot[AHEAD + 1];
#pragma unroll
  for (int i = 0; i <= AHEAD; ++i) {
    if (i < TB) {
      slot[i] = load_keys(ik + i * CI, nc);
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) slot[i].k[c] = KEY_PAD;
    }
  }
  fetch(0, 0);
  int st = -1, b = 1, r0 = 0, nr = 0;
  for (int r = 0; r < TB;) {
#pragma unroll
    for (int k = 0; k <= AHEAD; ++k, ++r) {
      if (r >= TB) break;
      if (r == r0 + nr) {           // the next stage
        if (st >= 0) __syncthreads();   // buffer b is refilled below
        ++st;
        b ^= 1;
        r0 = st * R;
        nr = min(R, TB - r0);
        if (st + 1 < nst) {
          fetch(st + 1, b ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        compact(st, b);
        __syncthreads();
      }
      row(r, r - r0, nr, b, slot[k]);
      if (r + AHEAD + 1 < TB) slot[k] = load_keys(ik + (r + AHEAD + 1) * CI,
                                                  nc);
    }
  }

  if (MODE == MODE_COMPACT) {
    for (int s = 0; s < sg; ++s) {
      // a column's final rank is its live count over the TB rows
      int nl[CPT], lo = p.CAPR, tot = 0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        nl[c] = c >= nc ? p.CAPR
                : MULTI ? srank[s * COLS + CPT * tid + c] : rank[c];
        lo = min(lo, nl[c]);
        tot += c < nc ? nl[c] : 0;
      }
      int* os = op + s * ostride;
      for (int rw = lo; rw < p.CAPR; ++rw)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (c < nc && rw >= nl[c]) os[rw * CI + c] = CODE_SENT;
      for (int o = 16; o > 0; o >>= 1)
        tot += __shfl_down_sync(0xffffffffu, tot, o);
      if (lane == 0) red[s * NWARPS + warp] = tot;
    }
    __syncthreads();
    if (tid < sg) {
      int tot = 0;
      for (int i = 0; i < NWARPS; ++i) tot += red[tid * NWARPS + i];
      p.nlive_part[((s0 + tid) * nblk + blk) * ncg + cg] = tot;
    }
  }
}

template <int MODE, bool MULTI>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&join_kernel<MODE, MULTI>);
}

const void* kernel_for(int mode, bool multi) {
  if (multi)
    return mode == MODE_COUNTS  ? kernel_of<MODE_COUNTS, true>()
           : mode == MODE_CODES ? kernel_of<MODE_CODES, true>()
                                : kernel_of<MODE_COMPACT, true>();
  return mode == MODE_COUNTS  ? kernel_of<MODE_COUNTS, false>()
         : mode == MODE_CODES ? kernel_of<MODE_CODES, false>()
                              : kernel_of<MODE_COMPACT, false>();
}

// Opts in to the launch's dynamic shared memory before every launch: the
// attribute belongs to the current device's context, so it is not set once
// per process.
int prepare(const void* fn, long long smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// S samples' [S, B, LW] cell grids against one [B, CI] index chunk, in
// sample groups of SG with lane_buf lanes a ring buffer and list_cap lane
// lists, smem bytes of dynamic shared memory (join_plan's). CI and (nt > 1)
// tile are even and ikey is 16-byte aligned.
extern "C" int join_launch(int mode, const long long* ikey, const int* gid,
                           const long long* dk, const int* dw, long long S,
                           long long B, long long CI, long long LW,
                           long long TB, long long nt, long long tile,
                           long long G, long long CAPR, long long SG,
                           long long lane_buf, long long list_cap,
                           long long smem, int* out,
                           int* nlive_part, void* stream) {
  const long long cs_p = nt >= 1 && LW % nt == 0 ? (LW / nt + 1) / 2 * 2 : 0;
  const long long need = 2 * lane_buf * 12 + 2 * list_cap * 8 +
                         (mode == MODE_COMPACT ? SG * COLS * 4 : 0);
  if (LW < 1 || TB < 1 || cs_p < 1 || B % TB || SG < 1 || SG > MAX_SG ||
      lane_buf % 2 || lane_buf < SG * nt * cs_p ||
      list_cap < lane_buf / cs_p || smem > SMEM_MAX || smem < need ||
      (TB + AHEAD) * CI >= (1LL << 31) || CAPR * CI >= (1LL << 31) ||
      CI % 2 || (nt > 1 && tile % 2) ||
      reinterpret_cast<unsigned long long>(ikey) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || B == 0 || CI == 0) return static_cast<int>(cudaGetLastError());
  const long long ncg = (CI + COLS - 1) / COLS;
  const dim3 grid(static_cast<unsigned>(B / TB * ncg), 1,
                  static_cast<unsigned>((S + SG - 1) / SG));
  const void* fn = kernel_for(mode, SG > 1);
  const int e = prepare(fn, smem);
  if (e != 0) return e;
  JoinArgs a;
  a.ikey = ikey;
  a.gid = gid;
  a.dk = dk;
  a.dw = dw;
  a.out = out;
  a.nlive_part = nlive_part;
  a.B = B;
  a.CI = CI;
  a.LW = static_cast<int>(LW);
  a.TB = static_cast<int>(TB);
  a.nt = static_cast<int>(nt);
  a.tile = static_cast<int>(tile);
  a.G = static_cast<int>(G);
  a.CAPR = static_cast<int>(CAPR);
  a.S = static_cast<int>(S);
  a.SG = static_cast<int>(SG);
  a.lane_buf = static_cast<int>(lane_buf);
  a.list_cap = static_cast<int>(list_cap);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(
      fn, grid, dim3(THREADS), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream)));
}

// The launch's occupancy as the card reports it, for SG samples a group
// at smem bytes of dynamic shared memory: registers a thread, static shared
// memory a CTA, resident CTAs a SM and threads a CTA -> info[0..3].
extern "C" int join_occupancy(int mode, long long SG, long long smem,
                              int* info) {
  const void* fn = kernel_for(mode, SG > 1);
  int e = prepare(fn, smem);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (e != 0) return e;
  int ctas = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, fn, THREADS, static_cast<size_t>(smem)));
  if (e != 0) return e;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = ctas;
  info[3] = THREADS;
  return 0;
}
