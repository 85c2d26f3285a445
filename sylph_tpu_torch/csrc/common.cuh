// Shared helpers of the port's CUDA kernels (plain C interface, ctypes).
//
// Conventions (sylph_tpu_torch/gpu/keys.py): a 64-bit hash is one int64 bit
// pattern, non-negative for every real hash; the pad key is -1 (the uint32
// pair (0xFFFFFFFF, 0xFFFFFFFF) of the JAX package); codes are int32 with
// SENT = -1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KEY_PAD (-1LL)
#define CODE_SENT (-1)
#define HIST_H 64

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// High 32 bits of an int64 key as a non-negative value (the pad's high word
// 0xFFFFFFFF sorts after every real one, as the uint32 sentinel did).
__device__ __forceinline__ long long key_hi(long long k) {
  return (long long)(((unsigned long long)k) >> 32);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// ---- the k-mer window code of csrc/seed.cu (B7) and csrc/seed_pack.cu
// (B6, B9, B10): the 2-bit window extraction, the canonical k-mer, the
// reference's bugged Wang mix, and the ranking of one 256-base piece's
// survivors in window order by warp ballots.
//
// Word format: 16 bases a uint32, LSB-first (base p at bits 2*(p&15) of
// word p>>4). A warp holds a piece of 256 bases as 18 words: lane j < 18
// holds word j (words 16 and 17 are the halo the last windows reach into,
// 0 past the row).

#define SEED_PIECE 256                    // bases (windows) a piece
#define SEED_PIECE_WORDS (SEED_PIECE / 16)
#define SEED_FULL 0xffffffffu

__device__ __forceinline__ uint64_t wang_mix_bugged(uint64_t key) {
  key = ~(key * 0x200001ULL);     // the reference's bug: NOT(k + k<<21)
  key = key ^ (key >> 24);
  key = key * 265ULL;             // k + (k << 3) + (k << 8)
  key = key ^ (key >> 14);
  key = key * 21ULL;              // k + (k << 2) + (k << 4)
  key = key ^ (key >> 28);
  return key * 0x80000001ULL;     // k + (k << 31)
}

// The 32 bases from bit s (even, < 32) of w0 on through w1 and w2,
// LSB-first.
__device__ __forceinline__ uint64_t bases_at(uint32_t w0, uint32_t w1,
                                             uint32_t w2, int s) {
  return (uint64_t)__funnelshift_r(w0, w1, s) |
         ((uint64_t)__funnelshift_r(w1, w2, s) << 32);
}

// The hash of the window whose bases start at bit s of w0: the reverse
// complement is (~v) masked to 2k bits, the forward k-mer v's 2-bit groups
// reversed (bit reverse, then swap the bits of each pair), shifted down by
// 64 - 2k.
__device__ __forceinline__ uint64_t window_hash(uint32_t w0, uint32_t w1,
                                                uint32_t w2, int s,
                                                uint64_t kmask, int down) {
  const uint64_t v = bases_at(w0, w1, w2, s);
  const uint64_t rc = ~v & kmask;
  uint64_t f = __brevll(v);
  f = ((f >> 1) & 0x5555555555555555ULL) | ((f & 0x5555555555555555ULL) << 1);
  f >>= down;
  return wang_mix_bugged(f < rc ? f : rc);
}

// The word of 16 one-byte codes (values 0..3; higher bits ignored), first
// code in the lowest bits. Each 32-bit part's 4 codes meet in its top byte
// by one multiply (the partial products land in disjoint 2-bit fields).
__device__ __forceinline__ uint32_t pack_codes16(uint4 q) {
  const uint32_t m = 0x01041040u;   // 2^24 + 2^18 + 2^12 + 2^6
  const uint32_t a = (q.x & 0x03030303u) * m, b = (q.y & 0x03030303u) * m;
  const uint32_t c = (q.z & 0x03030303u) * m, d = (q.w & 0x03030303u) * m;
  return __byte_perm(__byte_perm(a, b, 0x73), __byte_perm(c, d, 0x73),
                     0x5410);
}

// The hashes h0, h1 of the two adjacent windows whose bases start at bit s
// (even, at most 28) of w0, for 17 <= k <= 31 (so the low word of the
// k-mer mask is all ones and 64 - 2k < 32), in 32-bit halves. The first
// is window_hash's; the second's forward k-mer is the first's shifted up
// one base with base k of the first window appended, which spares it the
// bit reverse.
__device__ __forceinline__ void pair_hashes_wide(uint32_t w0, uint32_t w1,
                                                 uint32_t w2, int s,
                                                 uint32_t khi, int down,
                                                 uint64_t& h0, uint64_t& h1) {
  const uint32_t vlo = __funnelshift_r(w0, w1, s);
  const uint32_t vhi = __funnelshift_r(w1, w2, s);
  const uint32_t ulo = __funnelshift_r(w0, w1, s + 2);
  const uint32_t uhi = __funnelshift_r(w1, w2, s + 2);
  uint32_t phi = __brev(vlo), plo = __brev(vhi);
  phi = ((phi >> 1) & 0x55555555u) | ((phi & 0x55555555u) << 1);
  plo = ((plo >> 1) & 0x55555555u) | ((plo & 0x55555555u) << 1);
  const uint32_t flo = __funnelshift_r(plo, phi, down), fhi = phi >> down;
  const uint32_t nb = (vhi >> (32 - down)) & 3u;      // base k: bit 2k
  const uint32_t glo = (flo << 2) | nb;
  const uint32_t ghi = __funnelshift_l(flo, fhi, 2) & khi;
  const uint64_t f = ((uint64_t)fhi << 32) | flo;
  const uint64_t g = ((uint64_t)ghi << 32) | glo;
  const uint64_t rc0 = ((uint64_t)(~vhi & khi) << 32) | ~vlo;
  const uint64_t rc1 = ((uint64_t)(~uhi & khi) << 32) | ~ulo;
  h0 = wang_mix_bugged(f < rc0 ? f : rc0);
  h1 = wang_mix_bugged(g < rc1 ? g : rc1);
}

// The windows of one piece, ranked: lane j < 18 holds the piece's word j
// in `cur`; windows 0..last of the piece are inside the read (last may be
// past 255); `cnt` survivors were ranked before the piece. Each lane mixes
// 8 windows, two adjacent windows in each of 4 steps (step t: windows
// 64t + 2*lane and + 1; WIDE, for k >= 17: pair_hashes_wide); a survivor's
// rank is `cnt` plus the live windows of the lower lanes in its step (two
// ballots, popc under lanemask_lt), plus 1 for the odd window after a live
// even one. emit(rank, hash) is called for each survivor ranked below
// `cap`. Steps wholly past `last` are skipped, and the walk stops once
// `cnt` reaches `cap`. Returns the count after the piece (at least `cap`
// if it stopped early). Every lane of the warp calls it with the same
// last, cnt and cap.
template <bool WIDE, class Emit>
__device__ __forceinline__ int rank_piece(uint32_t cur, int last, int cnt,
                                          int cap, unsigned long long thr,
                                          int k, Emit emit) {
  const int lane = threadIdx.x & 31;
  const uint64_t kmask = (1ULL << (2 * k)) - 1ULL;
  const int down = 64 - 2 * k;
  const uint32_t nx1 = __shfl_down_sync(SEED_FULL, cur, 1);   // word j + 1
  const uint32_t nx2 = __shfl_down_sync(SEED_FULL, cur, 2);   // word j + 2
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t * 64 > last || cnt >= cap) break;
    const int b = t * 64 + 2 * lane;           // the lane's even window
    const int src = b >> 4;
    const uint32_t a0 = __shfl_sync(SEED_FULL, cur, src);
    const uint32_t a1 = __shfl_sync(SEED_FULL, nx1, src);
    const uint32_t a2 = __shfl_sync(SEED_FULL, nx2, src);
    const int s = 2 * (b & 15);
    uint64_t h0, h1;
    if constexpr (WIDE) {
      pair_hashes_wide(a0, a1, a2, s, (uint32_t)(kmask >> 32), down, h0, h1);
    } else {
      h0 = window_hash(a0, a1, a2, s, kmask, down);
      h1 = window_hash(a0, a1, a2, s + 2, kmask, down);
    }
    const bool e = b <= last && h0 < thr;
    const bool o = b < last && h1 < thr;
    const unsigned ev = __ballot_sync(SEED_FULL, e);
    const unsigned od = __ballot_sync(SEED_FULL, o);
    if (ev | od) {
      const int r = cnt + __popc(ev & lt) + __popc(od & lt);
      if (e && r < cap) emit(r, h0);
      if (o && r + e < cap) emit(r + e, h1);
      cnt += __popc(ev) + __popc(od);
    }
  }
  return cnt;
}
