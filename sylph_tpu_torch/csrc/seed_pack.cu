// B6, B9 and B10: fused FracMinHash seeding and per-read survivor packing.
//
// Replaces sylph_tpu/tpu/pallas_seeding.py::_butterfly_pack_kernel (B6,
// wrapper seed_pack_pallas), ::_seed_compact_kernel (B10, wrapper
// seed_compact_pallas) and ::_butterfly_pack_t_kernel (B9, wrapper
// seed_pack_pallas_t). Each seeds every k-mer window of a batch of reads
// given as 2-bit codes (one uint8 a base, values 0..3): the canonical k-mer
// min(forward, reverse complement), the bugged Wang mix, and the keep test
// hash < u64::MAX / c with the window inside the read (i + k <= len, len
// cut to L). Each read's surviving hashes are then packed in window order.
// Output contract (sylph_tpu_torch/gpu/seed_pack.py), int64 keys, pad -1:
//   rows (B6, B10): [N, L] codes -> out[N, width]; row r holds its first
//     min(cap, n_r) survivors, then -1. B6 is cap = width (128 for the
//     Pallas contract; the pipeline asks for its own cap), B10 cap =
//     min(128, 4L/c + 8) with width 128.
//   cols (B9): [L, N] codes, one read per column -> out[cap_rows, N];
//     column r holds its first min(cap_rows, n_r) survivors, then -1.
// The TPU kernels route survivors with butterfly networks of lane or
// sublane rolls because the TPU has no cheap scatter; here each survivor
// is written straight to its rank.
//
// Bound on the H100: operations. A [65536, 256] batch reads 16.8 MB of
// codes and writes 6.8 MB of keys at the pipeline's 13 lanes (67.1 MB at
// the Pallas width of 128). A window's mix, canonical choice, threshold
// test and rank, counted by the pipe that must issue them
// (chip_smoke.py's WINDOW_CLOCKS), take 29 instructions of the ALU pipe
// (64 lanes a clock an SM); the 8 IMAD of the mix go to the FMA pipe, and
// the 45.5 in all fit the SM's 128 lanes a clock of issue. That is 0.0257
// ms for the batch's 226 windows a read.
//
// The first version gave each read a block of 256 threads, one window a
// thread behind three block barriers a 256-window pass, and B9 a thread a
// read column with 1-byte loads: 0.1203 ms (B6) and 0.0836 ms (B9) by
// CUDA events at that batch. Both kernels now share one piece of device
// code (common.cuh::rank_piece, also B7's window hash): a warp holds a
// 256-base piece of one read as 18 words in registers (16 and a 2-word
// halo), each lane mixes 8 windows (two adjacent ones in each of 4 steps,
// their three words by __shfl_sync), and the ballots of a step rank its
// survivors in window order with no barrier and no shared scan. For k >=
// 17 (every main path) the second window of a lane's pair rolls its
// forward k-mer from the first's (a shift and base k appended) instead of
// a second bit reverse. Steps wholly past the read's last window are
// skipped (a 150-base read in a 256-base row takes 2 of 4), and the walk
// stops once the count reaches the cap.
// Design (rows): a warp a read. Lanes 0-17 load the piece's 16 words and
// halo as one 16-byte load of codes each and pack them by a multiply; a
// read longer than a piece is walked piece by piece with the count
// carried. A grid of the blocks resident on the card (the wrapper works it
// out once per device) strides over the reads, and a warp loads its next
// piece (or next read's first) while it mixes the current one. Survivors
// are stored at their rank and the row's -1 tail by one coalesced pass.
// Nothing is staged in shared memory, so L has no limit but the int32
// window index.
// Design (cols): a block of 8 warps takes a tile of 128 read columns and
// walks L in pieces of 256 bases: 144 threads each pack one word of 16
// reads from 16 base rows of 16-byte loads (row p of the tile is 128
// contiguous bytes), gathering each read's bytes by __byte_perm, into a
// [128][19] word table in shared memory (the 19th word pads the banks);
// then each warp takes 16 of the reads, lanes 0-17 read their word from
// the table and rank_piece does the rest. The first 32 output rows are
// staged in shared memory as [32][128] int64, pads included, and leave row
// by row as 1 KB of 16-byte stores; a survivor ranked past 32 (only where
// 4L/c + 8 > 32) is stored straight to its slot and the -1 tail past the
// count by a coalesced pass. A block stops walking once none of its reads
// has a window or a free slot left (__syncthreads_or). Codes off 16 bytes
// (N % 16 != 0) are read byte by byte.
//
// Measured (torch.profiler device time on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit; chip_smoke.py's rows, and in brackets python -m
// sylph_tpu_torch.kernel_ab, the first version against this one in one
// run): B6 at [65536, 256] and 13 lanes 0.0572 ms, 45% of the bound
// [0.1234 -> 0.0574], at 128 lanes 0.0596 ms, on 150-base reads 0.0368 ms
// against a 0.0136 ms bound [0.0973 -> 0.0351]; B9 0.0581 ms [0.0811 ->
// 0.0580]. Trial builds with 5 resident blocks a SM or 4 windows a lane
// moved B6 by 2% or less, the rolled forward k-mer by 5%. The compiled
// row kernel holds 1,408 SASS instructions for its 16 windows of code
// (kernel_ab's static counts), 88 a window with the per-read code; even
// all of them issued at 128 lanes a clock take 0.039 ms at [65536, 256].
// What holds the rest is not known: no pipe counter can be read.

#include "common.cuh"

#define WARP_WORDS (SEED_PIECE_WORDS + 2)   // a piece and its halo
#define ROW_THREADS 256              // 8 warps a block, a read a warp
#define ROW_WARPS (ROW_THREADS / 32)
#define ROW_MIN_BLOCKS 5             // 40 warps a SM (47 registers)
#define COL_THREADS 256
#define COL_WARPS (COL_THREADS / 32)
#define COL_MIN_BLOCKS 4
#define COL_TILE 128                 // read columns a block
#define COL_GROUPS (COL_TILE / 16)   // 16-byte column groups of a tile
#define COL_WSTRIDE (WARP_WORDS + 1)  // words a read in the table
#define COL_STAGE 32                 // output rows staged in shared memory

namespace {

template <bool WIDE>
__global__ void __launch_bounds__(ROW_THREADS, ROW_MIN_BLOCKS)
seed_pack_rows(const uint8_t* __restrict__ bases,
               const int* __restrict__ lengths, long long n, int L, int k,
               unsigned long long thr, int cap, int width,
               long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int nw = L >> 4;
  const int pieces = (nw + SEED_PIECE_WORDS - 1) / SEED_PIECE_WORDS;
  const long long stride = (long long)gridDim.x * ROW_WARPS;
  // lane j < 18 of piece p: the 16 codes of word 16p + j of read r, 0
  // past the row (packed where they are used, so that a prefetch does not
  // wait for its load)
  auto load = [&](long long r, int p) -> uint4 {
    const int j = p * SEED_PIECE_WORDS + lane;
    if (lane >= WARP_WORDS || j >= nw) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(bases + r * L) + j);
  };

  long long row = (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  uint4 codes = make_uint4(0u, 0u, 0u, 0u);
  int len = 0;
  if (row < n) {
    codes = load(row, 0);
    len = __ldg(lengths + row);
  }
  while (row < n) {
    const long long next = row + stride;
    const int last = min(len, L) - k;          // windows 0..last are inside
    const int np = last < 0 ? 0 : min(pieces, last / SEED_PIECE + 1);
    long long* o = out + row * width;
    int cnt = 0;
    bool ahead = false;                        // codes hold next's piece 0
    for (int p = 0;; ++p) {
      const uint32_t cur = pack_codes16(codes);
      if (p + 1 < np) {
        codes = load(row, p + 1);
      } else {
        if (next < n) {
          codes = load(next, 0);
          len = __ldg(lengths + next);
        }
        ahead = true;
      }
      if (p < np)
        cnt = rank_piece<WIDE>(cur, last - p * SEED_PIECE, cnt, cap, thr, k,
                               [&](int r, uint64_t h) {
                                 o[r] = (long long)h;
                               });
      if (p + 1 >= np || cnt >= cap) break;
    }
    for (int r = min(cnt, cap) + lane; r < width; r += 32) o[r] = KEY_PAD;
    row = next;
    if (!ahead && row < n) {                   // stopped at the cap
      codes = load(row, 0);
      len = __ldg(lengths + row);
    }
  }
}

// 16 codes of row p from column c on: one 16-byte load where the row is
// aligned and 16 columns are left, else byte by byte (0 past the tile).
__device__ __forceinline__ uint4 load_codes16(const uint8_t* p, int avail,
                                              bool vec) {
  if (vec && avail >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned long long lo = 0, hi = 0;
#pragma unroll 1
  for (int i = 0; i < min(avail, 16); ++i) {
    const unsigned long long b = __ldg(p + i);
    if (i < 8) lo |= b << (8 * i);
    else hi |= b << (8 * (i - 8));
  }
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                    (uint32_t)(hi >> 32));
}

// k >= 17 only, as B9's wrapper (the pair form of rank_piece).
__global__ void __launch_bounds__(COL_THREADS, COL_MIN_BLOCKS)
seed_pack_cols(const uint8_t* __restrict__ bases_t,
               const int* __restrict__ lengths, long long n, int L, int k,
               unsigned long long thr, int cap_rows, int vec_in,
               int vec_out, long long* __restrict__ out) {
  __shared__ uint32_t words[COL_TILE * COL_WSTRIDE];
  __shared__ long long stage[COL_STAGE * COL_TILE];     // [row][read]
  __shared__ int cnt[COL_TILE];
  __shared__ int lastw[COL_TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long col0 = (long long)blockIdx.x * COL_TILE;
  const int tile = static_cast<int>(min((long long)COL_TILE, n - col0));
  const int rows = min(cap_rows, COL_STAGE);
  for (int i = tid; i < rows * COL_TILE; i += COL_THREADS)
    stage[i] = KEY_PAD;
  if (tid < COL_TILE) {
    cnt[tid] = 0;
    lastw[tid] = tid < tile ? min(__ldg(lengths + col0 + tid), L) - k : -1;
  }
  for (int p0 = 0;; p0 += SEED_PIECE) {
    if (tid < COL_GROUPS * WARP_WORDS) {
      // word w of the piece for reads 16g .. 16g + 15: quad q's 4 rows
      // give, in byte b of z[q][c], read 4c + b's 4 codes packed
      const int g = tid % COL_GROUPS, w = tid / COL_GROUPS;
      const uint8_t* src = bases_t + col0 + 16 * g;
      const int avail = tile - 16 * g;
      uint32_t z[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) z[q][c] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = p0 + 16 * w + 4 * q + j;
          if (r < L && avail > 0) {
            const uint4 x = load_codes16(src + (long long)r * n, avail,
                                         vec_in);
            z[q][0] |= (x.x & 0x03030303u) << (2 * j);
            z[q][1] |= (x.y & 0x03030303u) << (2 * j);
            z[q][2] |= (x.z & 0x03030303u) << (2 * j);
            z[q][3] |= (x.w & 0x03030303u) << (2 * j);
          }
        }
      }
      uint32_t* dst = words + 16 * g * COL_WSTRIDE + w;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned sel = b | ((b + 4) << 4);
          dst[(4 * c + b) * COL_WSTRIDE] = __byte_perm(
              __byte_perm(z[0][c], z[1][c], sel),
              __byte_perm(z[2][c], z[3][c], sel), 0x5410);
        }
    }
    __syncthreads();
    bool more = false;
    for (int m = warp; m < tile; m += COL_WARPS) {
      const int last = lastw[m] - p0;          // the read's, in this piece
      int c = cnt[m];
      if (last < 0 || c >= cap_rows) continue;
      const uint32_t cur = lane < WARP_WORDS ? words[m * COL_WSTRIDE + lane]
                                            : 0u;
      long long* o = out + col0 + m;
      c = rank_piece<true>(cur, last, c, cap_rows, thr, k,
                           [&](int r, uint64_t h) {
                             if (r < COL_STAGE)
                               stage[r * COL_TILE + m] = (long long)h;
                             else
                               o[(long long)r * n] = (long long)h;
                           });
      if (lane == 0) cnt[m] = c;
      more |= last >= SEED_PIECE && c < cap_rows;
    }
    // also the barrier before the next piece rewrites the word table
    if (!__syncthreads_or(more)) break;
  }
  for (int i = tid; i < rows * (COL_TILE / 2); i += COL_THREADS) {
    const int r = i / (COL_TILE / 2), c = 2 * (i % (COL_TILE / 2));
    long long* o = out + (long long)r * n + col0 + c;
    const long long* s = stage + r * COL_TILE + c;
    if (vec_out && c + 1 < tile) {
      *reinterpret_cast<longlong2*>(o) = make_longlong2(s[0], s[1]);
    } else {
      if (c < tile) o[0] = s[0];
      if (c + 1 < tile) o[1] = s[1];
    }
  }
  for (int r = rows + tid / COL_TILE; r < cap_rows;
       r += COL_THREADS / COL_TILE) {
    const int c = tid % COL_TILE;
    if (c < tile && r >= cnt[c]) out[(long long)r * n + col0 + c] = KEY_PAD;
  }
}

// the instances the main paths launch (k >= 17)
const void* kernel_fn(int cols) {
  return cols ? reinterpret_cast<const void*>(&seed_pack_cols)
              : reinterpret_cast<const void*>(&seed_pack_rows<true>);
}

}  // namespace

// B6/B10: n rows of L codes (L a multiple of 16, rows 16-byte aligned),
// 1 <= k <= 31, 1 <= cap <= width. grid: the blocks to launch
// (gpu/seed_pack.py::row_grid: a warp a read, at most the blocks resident
// on the card, which stride over the reads).
extern "C" int seed_pack_launch(const uint8_t* bases, const int* lengths,
                                long long n, int L, int k,
                                unsigned long long thr, int cap, int width,
                                long long* out, long long grid,
                                void* stream) {
  if (L < 0 || L % 16 || k < 1 || k > 31 || cap < 1 || cap > width ||
      grid < 0 || grid >= (1LL << 31) ||
      reinterpret_cast<unsigned long long>(bases) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && grid > 0) {
    auto kern = k >= 17 ? seed_pack_rows<true> : seed_pack_rows<false>;
    kern<<<static_cast<unsigned>(grid), ROW_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
        bases, lengths, n, L, k, thr, cap, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// B9: [L, n] codes, one read a column, 17 <= k <= 31, cap_rows >= 0.
// blocks: ceil(n / 128), a tile of 128 columns each
// (gpu/seed_pack.py::col_blocks).
extern "C" int seed_pack_t_launch(const uint8_t* bases_t, const int* lengths,
                                  long long n, int L, int k,
                                  unsigned long long thr, int cap_rows,
                                  long long* out, long long blocks,
                                  void* stream) {
  if (L < 0 || k < 17 || k > 31 || cap_rows < 0 || blocks < 0 ||
      blocks >= (1LL << 31) || blocks * COL_TILE < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const int vec_in =
        n % 16 == 0 && reinterpret_cast<unsigned long long>(bases_t) % 16 == 0;
    const int vec_out =
        n % 2 == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0;
    seed_pack_cols<<<static_cast<unsigned>(blocks), COL_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        bases_t, lengths, n, L, k, thr, cap_rows, vec_in, vec_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row (cols = 0) or column kernel's occupancy as the card reports it:
// registers a thread, static shared memory a block, resident blocks a SM
// and threads a block -> info[0..3].
extern "C" int seed_pack_occupancy(int cols, int* info) {
  cudaFuncAttributes attr;
  int e = static_cast<int>(cudaFuncGetAttributes(&attr, kernel_fn(cols)));
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_fn(cols), cols ? COL_THREADS : ROW_THREADS, 0));
  if (e != 0) return e;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = per_sm;
  info[3] = cols ? COL_THREADS : ROW_THREADS;
  return 0;
}
