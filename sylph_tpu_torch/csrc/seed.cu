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
// Bound on the H100: about balanced. Bytes: N*L/4 read and N*L*9 written
// (155 MB for a [65536, 256] batch, 46 us at 3.35 TB/s); operations: the
// 64-bit mix, the canonical choice and the threshold test are about 45
// int32 instructions a window (about 45 us at the INT32 issue rate).
//
// Design: one block of 256 threads per read row stages the row's words in
// shared memory (plus two zero words, so windows past L read zeros); each
// thread takes windows i, i+256, ... A window of k <= 31 bases spans at
// most three words: one funnel shift gives the window's bases LSB-first in
// a uint64 v. The reverse complement is (~v) masked to 2k bits; the forward
// k-mer is v's 2-bit groups reversed (bit reverse, then swap the bits of
// each pair), shifted down by 64 - 2k. No per-base loop.

#include "common.cuh"

#define SEED_THREADS 256

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

__global__ void __launch_bounds__(SEED_THREADS)
seed_kernel(const uint32_t* __restrict__ packed,
            const int* __restrict__ lengths, int L, int k,
            unsigned long long thr, long long* __restrict__ hash,
            uint8_t* __restrict__ keep) {
  extern __shared__ uint32_t words[];
  const long long row = blockIdx.x;
  const int nw = L >> 4;
  const uint32_t* src = packed + row * nw;
  for (int j = threadIdx.x; j < nw + 2; j += SEED_THREADS)
    words[j] = j < nw ? src[j] : 0u;
  __syncthreads();
  const int len = lengths[row];
  const uint64_t kmask = (1ULL << (2 * k)) - 1ULL;
  const int down = 64 - 2 * k;
  long long* h_out = hash + row * L;
  uint8_t* k_out = keep + row * L;
  for (int i = threadIdx.x; i < L; i += SEED_THREADS) {
    const int w = i >> 4, s = 2 * (i & 15);
    const uint64_t lo64 = (uint64_t)words[w] | ((uint64_t)words[w + 1] << 32);
    uint64_t v = lo64 >> s;
    if (s) v |= (uint64_t)words[w + 2] << (64 - s);
    const uint64_t rc = ~v & kmask;
    uint64_t f = __brevll(v);
    f = ((f >> 1) & 0x5555555555555555ULL) | ((f & 0x5555555555555555ULL) << 1);
    f >>= down;
    const uint64_t h = wang_mix_bugged(f < rc ? f : rc);
    h_out[i] = (long long)h;
    k_out[i] = (h < thr && i + k <= len) ? 1 : 0;
  }
}

}  // namespace

extern "C" int seed_launch(const uint32_t* packed, const int* lengths,
                           long long n, int L, int k, unsigned long long thr,
                           long long* hash, uint8_t* keep, void* stream) {
  if (n > 0) {
    const size_t smem = (size_t)((L >> 4) + 2) * sizeof(uint32_t);
    seed_kernel<<<static_cast<unsigned>(n), SEED_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(packed, lengths, L, k,
                                                       thr, hash, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
