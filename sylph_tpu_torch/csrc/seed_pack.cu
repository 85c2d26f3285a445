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
// Bound on the H100: bytes for B6 at the Pallas width, operations below
// it. A [65536, 256] batch reads 16.8 MB of codes and writes 67.1 MB of
// keys at width 128 (6.8 MB at the pipeline's cap of 13); the 64-bit mix,
// the canonical choice and the threshold test are about 45 int32
// instructions a window.
//
// Design (rows): one block of 256 threads per read. The block packs its
// row into 2-bit words in shared memory (16-byte loads, 16 bases a word,
// LSB-first, two zero words after), then takes 256 windows a pass: each
// thread extracts its window with one funnel shift (as csrc/seed.cu does),
// a warp ballot and __popc rank the survivors inside each warp, warp 0
// scans the 8 warp counts, and each survivor below the cap is stored at its
// rank. Passes stop at the read's last window or once the cap is reached.
// Design (cols): one thread per read column, neighbouring threads on
// neighbouring columns. The thread first writes its column's cap_rows
// slots with -1 (every row coalesced across the warp), then walks its
// read's bases with a rolling forward and reverse-complement k-mer and
// overwrites slot n with the n-th survivor; it stops at the read's end or
// at cap_rows.

#include "common.cuh"

#define PACK_THREADS 256
#define PACK_WARPS (PACK_THREADS / 32)
#define COL_THREADS 256

namespace {

__device__ __forceinline__ uint64_t wang_mix_bugged(uint64_t key) {
  key = ~(key + (key << 21));     // the reference's bug: NOT(k + k<<21)
  key = key ^ (key >> 24);
  key = key + (key << 3) + (key << 8);
  key = key ^ (key >> 14);
  key = key + (key << 2) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

__global__ void __launch_bounds__(PACK_THREADS)
seed_pack_rows(const uint8_t* __restrict__ bases,
               const int* __restrict__ lengths, int L, int k,
               unsigned long long thr, int cap, int width,
               long long* __restrict__ out) {
  extern __shared__ uint32_t words[];   // L/16 + 2
  __shared__ int wcount[PACK_WARPS];
  __shared__ int wtotal;
  const long long row = blockIdx.x;
  const int nw = L >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* src = reinterpret_cast<const uint4*>(bases + row * L);
  for (int w = threadIdx.x; w < nw + 2; w += PACK_THREADS) {
    uint32_t word = 0u;
    if (w < nw) {
      const uint4 q = src[w];
      const uint32_t part[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= ((part[i] >> (8 * j)) & 3u) << (2 * (4 * i + j));
    }
    words[w] = word;
  }
  __syncthreads();
  const int last = min(lengths[row], L) - k;   // windows 0..last are inside
  const uint64_t kmask = (1ULL << (2 * k)) - 1ULL;
  const int down = 64 - 2 * k;
  long long* o = out + row * width;
  int base = 0;                                // survivors ranked so far
  for (int t0 = 0; t0 <= last && base < cap; t0 += PACK_THREADS) {
    const int i = t0 + threadIdx.x;
    uint64_t h = 0;
    bool live = false;
    if (i <= last) {
      const int w = i >> 4, s = 2 * (i & 15);
      uint64_t v = ((uint64_t)words[w] | ((uint64_t)words[w + 1] << 32)) >> s;
      if (s) v |= (uint64_t)words[w + 2] << (64 - s);
      const uint64_t rc = ~v & kmask;
      uint64_t f = __brevll(v);
      f = ((f >> 1) & 0x5555555555555555ULL) |
          ((f & 0x5555555555555555ULL) << 1);
      f >>= down;
      h = wang_mix_bugged(f < rc ? f : rc);
      live = h < thr;
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int c = lane < PACK_WARPS ? wcount[lane] : 0;
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane < PACK_WARPS) wcount[lane] = incl - c;   // exclusive offsets
      if (lane == 31) wtotal = incl;
    }
    __syncthreads();
    if (live) {
      const int r = base + wcount[warp] + __popc(m & lanemask_lt());
      if (r < cap) o[r] = (long long)h;
    }
    base += wtotal;
    __syncthreads();          // wcount and wtotal are rewritten next pass
  }
  for (int r = min(base, cap) + threadIdx.x; r < width; r += PACK_THREADS)
    o[r] = KEY_PAD;
}

__global__ void __launch_bounds__(COL_THREADS)
seed_pack_cols(const uint8_t* __restrict__ bases_t,
               const int* __restrict__ lengths, long long n, int L, int k,
               unsigned long long thr, int cap_rows,
               long long* __restrict__ out) {
  const long long col = (long long)blockIdx.x * COL_THREADS + threadIdx.x;
  if (col >= n) return;
  for (int r = 0; r < cap_rows; ++r) out[r * n + col] = KEY_PAD;
  const int len = min(lengths[col], L);
  const uint64_t kmask = (1ULL << (2 * k)) - 1ULL;
  const int top = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int cnt = 0;
  for (int p = 0; p < len && cnt < cap_rows; ++p) {
    const uint64_t b = bases_t[p * n + col] & 3u;
    fwd = ((fwd << 2) | b) & kmask;
    rc = (rc >> 2) | ((3ULL - b) << top);
    if (p >= k - 1) {                  // window p - k + 1 is complete
      const uint64_t h = wang_mix_bugged(fwd < rc ? fwd : rc);
      if (h < thr) out[(long long)(cnt++) * n + col] = (long long)h;
    }
  }
}

}  // namespace

extern "C" int seed_pack_launch(const uint8_t* bases, const int* lengths,
                                long long n, int L, int k,
                                unsigned long long thr, int cap, int width,
                                long long* out, void* stream) {
  if (n > 0) {
    const size_t smem = (size_t)((L >> 4) + 2) * sizeof(uint32_t);
    seed_pack_rows<<<static_cast<unsigned>(n), PACK_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        bases, lengths, L, k, thr, cap, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seed_pack_t_launch(const uint8_t* bases_t, const int* lengths,
                                  long long n, int L, int k,
                                  unsigned long long thr, int cap_rows,
                                  long long* out, void* stream) {
  if (n > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n + COL_THREADS - 1) / COL_THREADS);
    seed_pack_cols<<<blocks, COL_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        bases_t, lengths, n, L, k, thr, cap_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}
