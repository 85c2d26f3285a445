// B7: FracMinHash read seeding over the 2-bit packed wire format.
//
// Replaces sylph_tpu/tpu/pallas_seeding.py::_seed_kernel (wrapper
// seed_hashes_pallas), which builds every window's forward and
// reverse-complement k-mer with lane rolls over an unpacked [rows, L] tile,
// takes the canonical one, applies the bugged Wang mix on uint32 pairs and
// tests the FracMinHash threshold. Output contract (gpu/seeding.py): for a
// [N, L/16] word batch (16 bases a word, LSB-first: base p at bits
// 2*(p&15) of word p>>4) and read lengths [N], hash[r, i] is the mix of the
// canonical k-mer starting at base i (bases past L read as 0) as one
// uint64 bit pattern in int64, and keep[r, i] = 1 iff the hash is below
// u64::MAX / c and the window lies inside the read (i + k <= len[r]); every
// column i > L - k therefore has keep 0. The unpack pass of the JAX
// pipeline (pipeline.py::unpack_bases) is fused away.
//
// Bound on the H100: bytes. N*L/4 read and N*L*9 written (155 MB for a
// [65536, 256] batch, 46 us at 3.35 TB/s); operations: the window's mix,
// canonical choice and threshold test, counted by pipe in chip_smoke.py
// (WINDOW_CLOCKS: 29 ALU-pipe instructions a window at 64 lanes a clock an
// SM), about 26 us.
//
// Design. The first version ran a block of 256 threads a row, one window a
// thread behind a block barrier: 65,536 tiny blocks, no overlap of a
// block's loads with its mixes and one independent mix a thread (0.1122 ms
// at [65536, 256], 41% of the bound). Here a warp owns a piece of 256
// bases of one row (a whole 150-bp read row): lanes 0-17 load the piece's
// 16 words and the 2-word halo (zeros past L) in one coalesced load and
// keep them in registers; a window's three words arrive by __shfl_sync, so
// nothing goes through shared memory and no barrier is needed. Each lane
// mixes 8 windows, two adjacent windows in each of 4 steps, and stores
// their hashes as one 16-byte store (a warp writes 512 contiguous bytes a
// step); the keep bits are gathered by ballots and each lane stores the 8
// keep bytes of windows 8*lane.. as one 8-byte store. A grid of the blocks
// resident on the card (the wrapper works it out once per device) strides
// over the pieces (no wave tail), and a warp loads its next piece's words
// while it mixes the current one. The window
// algebra: one funnel shift gives the window's bases LSB-first in a uint64
// v; the reverse complement is (~v) masked to 2k bits, the forward k-mer is
// v's 2-bit groups reversed (bit reverse, then swap the bits of each pair),
// shifted down by 64 - 2k. No per-base loop.
//
// Measured (chip_smoke.py's "B7_seed" rows, torch.profiler device time on
// an NVIDIA H100 80GB HBM3 at a 700 W power limit): 0.0591 ms at [65536,
// 256] (78.5% of the bound: 155 MB moved at 2.63 TB/s; kbench's identity
// copy moves 2.92 TB/s by the same timer in python -m
// sylph_tpu_torch.kernel_ab), 0.0303 ms on [2048, 4096] genome rows. The
// compiled mix takes more instructions than the count above (kernel_ab
// prints the SASS counts); trial builds with fewer
// instructions, or with other register budgets, were no faster, so the
// stores may be what holds it, but no measurement here shows that.

#include "common.cuh"

#define SEED_THREADS 256                  // 8 warps a block
#define SEED_WARPS (SEED_THREADS / 32)
#define SEED_MIN_BLOCKS 4                 // at most 64 registers a thread

namespace {

// Bits 0-3 of x to bytes 0-3 of a word (each byte 0 or 1).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// Keep bytes of 4 adjacent windows from 2 even-window bits (e) and 2
// odd-window bits (o): e0 o0 e1 o1.
__device__ __forceinline__ uint32_t keep_bytes(uint32_t e, uint32_t o) {
  return spread4((e & 1u) | ((o & 1u) << 1) | ((e & 2u) << 1) |
                 ((o & 2u) << 2));
}

__global__ void __launch_bounds__(SEED_THREADS, SEED_MIN_BLOCKS)
seed_kernel(const uint32_t* __restrict__ packed,
            const int* __restrict__ lengths, long long n_rows, int nw,
            int k, unsigned long long thr, long long* __restrict__ hash,
            uint8_t* __restrict__ keep) {
  const int lane = threadIdx.x & 31;
  const int L = nw * 16;
  const int pieces = (nw + SEED_PIECE_WORDS - 1) / SEED_PIECE_WORDS;
  const long long units = n_rows * pieces;
  const long long stride = (long long)gridDim.x * SEED_WARPS;
  const long long stride_r = stride / pieces;
  const int stride_p = static_cast<int>(stride - stride_r * pieces);
  const uint64_t kmask = (1ULL << (2 * k)) - 1ULL;
  const int down = 64 - 2 * k;

  long long u = (long long)blockIdx.x * SEED_WARPS + (threadIdx.x >> 5);
  long long row = u / pieces;               // this warp's first unit
  int p = static_cast<int>(u - row * pieces);
  // the piece's words (lane j < 18: word 16p + j, 0 past the row) and the
  // row's length, loaded one unit ahead
  auto load = [&](long long r, int q, uint32_t& w, int& n) {
    const int j = q * SEED_PIECE_WORDS + lane;
    w = (lane < SEED_PIECE_WORDS + 2 && j < nw) ? __ldg(packed + r * nw + j)
                                                : 0u;
    n = __ldg(lengths + r);
  };
  uint32_t word = 0;
  int len = 0;
  if (u < units) load(row, p, word, len);
  while (u < units) {
    const uint32_t cur = word;
    const int clen = len;
    const long long crow = row;
    const int cp = p;
    u += stride;
    row += stride_r;
    p += stride_p;
    if (p >= pieces) {
      p -= pieces;
      ++row;
    }
    if (u < units) load(row, p, word, len);

    const int i0 = cp * SEED_PIECE;            // the piece's first window
    const int rem = min(SEED_PIECE, L - i0);   // its windows (a multiple of 16)
    const uint32_t nx1 = __shfl_down_sync(SEED_FULL, cur, 1);   // word j + 1
    const uint32_t nx2 = __shfl_down_sync(SEED_FULL, cur, 2);   // word j + 2
    long long* hrow = hash + crow * L + i0;
    unsigned ev[4], od[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int b = t * 64 + 2 * lane;         // the lane's even window
      const int src = b >> 4;
      const uint32_t a0 = __shfl_sync(SEED_FULL, cur, src);
      const uint32_t a1 = __shfl_sync(SEED_FULL, nx1, src);
      const uint32_t a2 = __shfl_sync(SEED_FULL, nx2, src);
      const int s = 2 * (b & 15);
      const uint64_t h0 = window_hash(a0, a1, a2, s, kmask, down);
      const uint64_t h1 = window_hash(a0, a1, a2, s + 2, kmask, down);
      const bool in = b < rem;
      if (in)
        *reinterpret_cast<longlong2*>(hrow + b) =
            make_longlong2((long long)h0, (long long)h1);
      const int i = i0 + b;
      ev[t] = __ballot_sync(SEED_FULL, in && h0 < thr && i + k <= clen);
      od[t] = __ballot_sync(SEED_FULL, in && h1 < thr && i + 1 + k <= clen);
    }
    // windows 8*lane .. 8*lane + 7: step lane / 8, lanes 4*(lane % 8) ..
    if (8 * lane < rem) {
      const int t = lane >> 3, sh = 4 * (lane & 7);
      const unsigned e =
          ((t == 0 ? ev[0] : t == 1 ? ev[1] : t == 2 ? ev[2] : ev[3]) >> sh);
      const unsigned o =
          ((t == 0 ? od[0] : t == 1 ? od[1] : t == 2 ? od[2] : od[3]) >> sh);
      *reinterpret_cast<uint2*>(keep + crow * L + i0 + 8 * lane) =
          make_uint2(keep_bytes(e, o), keep_bytes(e >> 2, o >> 2));
    }
  }
}

const void* seed_fn() { return reinterpret_cast<const void*>(&seed_kernel); }

}  // namespace

// hash [n, L] and keep [n, L] of n rows of L/16 packed words; L a
// multiple of 16 and at least 16, 1 <= k <= 31; both outputs 16-byte
// aligned (the wrapper allocates them). grid: the blocks resident on the
// card at once (gpu/seeding.py::_seed_grid, from seed_occupancy), the most
// the launch takes; its warps stride over the row pieces.
extern "C" int seed_launch(const uint32_t* packed, const int* lengths,
                           long long n, int L, int k, unsigned long long thr,
                           long long* hash, uint8_t* keep, long long grid,
                           void* stream) {
  if (L < 16 || L % 16 || k < 1 || k > 31 || grid < 1 ||
      grid >= (1LL << 31) ||
      reinterpret_cast<unsigned long long>(hash) % 16 ||
      reinterpret_cast<unsigned long long>(keep) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int nw = L >> 4;
  const long long units = n * ((nw + SEED_PIECE_WORDS - 1) / SEED_PIECE_WORDS);
  const long long need = (units + SEED_WARPS - 1) / SEED_WARPS;
  seed_kernel<<<static_cast<unsigned>(need < grid ? need : grid),
                SEED_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, lengths, n, nw, k, thr, hash, keep);
  return static_cast<int>(cudaGetLastError());
}

// The launch's occupancy as the card reports it: registers a thread,
// static shared memory a block, resident blocks a SM and threads a block
// -> info[0..3].
extern "C" int seed_occupancy(int* info) {
  cudaFuncAttributes attr;
  int e = static_cast<int>(cudaFuncGetAttributes(&attr, seed_fn()));
  if (e != 0) return e;
  int per_sm = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seed_fn(), SEED_THREADS, 0));
  if (e != 0) return e;
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = per_sm;
  info[3] = SEED_THREADS;
  return 0;
}
