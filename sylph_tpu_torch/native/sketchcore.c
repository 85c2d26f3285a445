/* Native sketch-construction core of sylph_tpu_torch: the host-side hot
 * loops of read and genome sketching. A trimmed copy of the JAX package's
 * native/sketchcore.c (the one-shot fold and the radix sort are left out),
 * built into build/native/ under its own name
 * (sylph_tpu_torch/core/native_core.py).
 *
 * 1. sk_fold_* — the reference's per-k-mer counting + PCR-duplicate
 *    removal fold (sylph src/sketch.rs:690-731 dup_removal_lsh_full[_exact],
 *    applied at :828-876 and :930-939): an open-addressing u64->u32 count
 *    map (FxHashMap equivalent) plus an exact (kmer, fingerprint) pair set
 *    or a scalable blocked-bloom pair filter; results in first-insertion
 *    order.
 * 2. sk_spacing_scan — the greedy genome spacing filter.
 * 3. sx_seed_concat, sx_seed_positions — scalar/AVX FracMinHash seeding of
 *    concatenated reads, and of genome contigs with window end positions.
 * 4. sk_mean_fold, sx_fp_single, sx_fp_paired — mean read length and the
 *    dedup fingerprints.
 *
 * Plain C ABI for ctypes; buffers are malloc'd here, freed by sk_free.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------- open-addressing tables ---------- */

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

typedef struct {            /* packed 16-byte entry: one probe touches ONE
                             * cache line (the old split keys/vals/used
                             * arrays cost three misses per probe, and the
                             * fold is memory-latency-bound) */
    uint64_t key;
    uint32_t val;
    uint32_t used;
} MapEnt;

typedef struct {            /* u64 key -> u32 value */
    MapEnt *e;
    uint64_t cap, n;        /* cap is power of two */
} Map64;

static int map_init(Map64 *m, uint64_t cap) {
    m->cap = cap;
    m->n = 0;
    m->e = (MapEnt *)calloc(cap, sizeof(MapEnt));
    return m->e != NULL;
}

static inline int64_t map_slot_h(Map64 *m, uint64_t h, uint64_t key) {
    uint64_t mask = m->cap - 1;
    uint64_t i = h & mask;
    while (m->e[i].used && m->e[i].key != key) i = (i + 1) & mask;
    return (int64_t)i;
}

static inline int64_t map_slot(Map64 *m, uint64_t key) {
    return map_slot_h(m, mix64(key), key);
}

static int map_rehash(Map64 *m, uint64_t ncap);

static int map_grow(Map64 *m) {
    /* factor 4 once large: the rehash of a multi-10M-entry table is the
     * dominant fold cost, so amortize to ~1.33 moves/key instead of 2 */
    return map_rehash(m, m->cap * (m->cap >= (1u << 20) ? 4 : 2));
}

static int map_rehash(Map64 *m, uint64_t ncap) {
    Map64 nm;
    if (!map_init(&nm, ncap)) return 0;
    uint64_t nmask = nm.cap - 1;
    for (uint64_t i = 0; i < m->cap; i++) {
        /* the rehash is random-write bound at tens of millions of
         * entries; prefetch the destination line a few sources ahead */
        if (i + 8 < m->cap && m->e[i + 8].used)
            __builtin_prefetch(&nm.e[mix64(m->e[i + 8].key) & nmask], 1);
        if (m->e[i].used) {
            int64_t s = map_slot(&nm, m->e[i].key);
            nm.e[s] = m->e[i];
        }
    }
    nm.n = m->n;
    free(m->e);
    *m = nm;
    return 1;
}

typedef struct {            /* packed 128-bit key; empty = (0,0) */
    uint64_t k1, k2;
} SetEnt;

typedef struct {            /* 128-bit key set: (k1, k2) */
    SetEnt *e;
    uint64_t cap, n;
    int zero_present;       /* the one key the (0,0)-empty packing cannot
                             * hold in-table (kept exact, not ignored) */
} Set128;

static int set_init(Set128 *s, uint64_t cap) {
    s->cap = cap;
    s->n = 0;
    s->zero_present = 0;
    s->e = (SetEnt *)calloc(cap, sizeof(SetEnt));
    return s->e != NULL;
}

static inline uint64_t set_hash(uint64_t a, uint64_t b) {
    return mix64(a) ^ mix64(b * 0x9e3779b97f4a7c15ULL);
}

static inline int64_t set_slot_h(Set128 *s, uint64_t h, uint64_t a,
                                 uint64_t b) {
    uint64_t mask = s->cap - 1;
    uint64_t i = h & mask;
    while (!(s->e[i].k1 == 0 && s->e[i].k2 == 0)
           && !(s->e[i].k1 == a && s->e[i].k2 == b))
        i = (i + 1) & mask;
    return (int64_t)i;
}

static int set_rehash(Set128 *s, uint64_t ncap);

static int set_grow(Set128 *s) {
    return set_rehash(s, s->cap * (s->cap >= (1u << 20) ? 4 : 2));
}

static int set_rehash(Set128 *s, uint64_t ncap) {
    Set128 ns;
    if (!set_init(&ns, ncap)) return 0;
    uint64_t nmask = ns.cap - 1;
    for (uint64_t i = 0; i < s->cap; i++) {
        if (i + 8 < s->cap
            && !(s->e[i + 8].k1 == 0 && s->e[i + 8].k2 == 0))
            __builtin_prefetch(
                &ns.e[set_hash(s->e[i + 8].k1, s->e[i + 8].k2) & nmask], 1);
        if (!(s->e[i].k1 == 0 && s->e[i].k2 == 0)) {
            int64_t j = set_slot_h(&ns, set_hash(s->e[i].k1, s->e[i].k2),
                                   s->e[i].k1, s->e[i].k2);
            ns.e[j] = s->e[i];
        }
    }
    ns.n = s->n;
    ns.zero_present = s->zero_present;
    free(s->e);
    *s = ns;
    return 1;
}

/* returns 1 if (a,b) was already present, else inserts and returns 0;
 * h must be set_hash(a, b) (precomputed by the fold's scratch pass) */
static int set_check_insert_h(Set128 *s, uint64_t h, uint64_t a,
                              uint64_t b, int *oom) {
    if (a == 0 && b == 0) {
        if (s->zero_present) return 1;
        s->zero_present = 1;
        return 0;
    }
    int64_t i = set_slot_h(s, h, a, b);
    if (s->e[i].k1 == a && s->e[i].k2 == b) return 1;
    s->e[i].k1 = a;
    s->e[i].k2 = b;
    s->n++;
    if (s->n * 10 > s->cap * 7 && !set_grow(s)) *oom = 1;
    return 0;
}

/* ---------- scalable blocked-bloom pair filter (fpr > 0) ----------
 *
 * Memory-bounded replacement for the exact pair set, mirroring the
 * reference's ScalableCuckooFilter role (sylph src/sketch.rs:733-768,
 * 796-804): an approximate member test whose total false-positive
 * probability is bounded by the user's --fpr. Chain of blocked-bloom
 * levels; level i holds CAP0<<i keys at fpr_i = fpr / 2^(i+1) (geometric
 * sum <= fpr). Each key touches ONE 512-bit cache line per level. The
 * layout is a deterministic function of (key, level) so the pure-Python
 * fallback reproduces decisions bit-for-bit. */

#define BLOOM_CAP0 (1u << 23)
#define BLOOM_MAX_LEVELS 24

typedef struct {
    uint64_t *bits;         /* n_blocks * 8 u64 words */
    uint64_t n_blocks;
    uint32_t k;             /* hash bits set per key */
    uint64_t cap, n;
} BloomLevel;

typedef struct {
    BloomLevel lv[BLOOM_MAX_LEVELS];
    int n_levels;
    double fpr;
} Bloom;

static int bloom_level_init(BloomLevel *l, uint64_t cap, double fpr_i) {
    /* k = ceil(log2(1/fpr_i)); m = cap*k/ln2 bits, rounded up to blocks */
    uint32_t k = 1;
    double p = 0.5;
    while (p > fpr_i && k < 21) { k++; p *= 0.5; }
    l->k = k;
    double bits = (double)cap * (double)k / 0.6931471805599453;
    l->n_blocks = (uint64_t)(bits / 512.0) + 1;
    l->bits = (uint64_t *)calloc(l->n_blocks * 8, sizeof(uint64_t));
    l->cap = cap;
    l->n = 0;
    return l->bits != NULL;
}

static int bloom_init(Bloom *b, double fpr) {
    b->fpr = fpr;
    b->n_levels = 1;
    return bloom_level_init(&b->lv[0], BLOOM_CAP0, fpr * 0.5);
}

static void bloom_free(Bloom *b) {
    for (int i = 0; i < b->n_levels; i++) free(b->lv[i].bits);
}

/* 1 if the key hashes all-set in level li (maybe-present) */
static inline int bloom_level_test(const BloomLevel *l, int li,
                                   uint64_t h, int insert) {
    /* block: multiply-shift of a level-salted rehash; in-block bit
     * positions: consecutive 9-bit fields of two further rehashes */
    uint64_t h1 = mix64(h + (uint64_t)(2 * li + 1));
    uint64_t block = (uint64_t)(((__uint128_t)h1 * l->n_blocks) >> 64);
    uint64_t *blk = l->bits + block * 8;
    uint64_t h2 = mix64(h1 ^ 0x9e3779b97f4a7c15ULL);
    uint64_t h3 = mix64(h2 ^ 0xd1b54a32d192ed03ULL);
    uint64_t h4 = mix64(h3 ^ 0x2545f4914f6cdd1dULL);
    int all = 1;
    for (uint32_t j = 0; j < l->k; j++) {
        uint64_t hw = (j < 7) ? h2 : (j < 14) ? h3 : h4;
        uint32_t pos = (uint32_t)((hw >> (9 * (j % 7))) & 511u);
        uint64_t bit = 1ULL << (pos & 63u);
        uint64_t *word = blk + (pos >> 6);
        if (!(*word & bit)) {
            all = 0;
            if (insert) *word |= bit; else return 0;
        }
    }
    return all;
}

/* contains-then-insert, matching set_check_insert semantics; h must be
 * set_hash(kmer, fp_pair) — the same derivation as before, hoisted to
 * the fold's scratch pass so it can drive prefetch */
static int bloom_check_insert_h(Bloom *b, uint64_t h, int *oom) {
    for (int i = 0; i < b->n_levels; i++)
        if (bloom_level_test(&b->lv[i], i, h, 0)) return 1;
    BloomLevel *last = &b->lv[b->n_levels - 1];
    if (last->n >= last->cap && b->n_levels < BLOOM_MAX_LEVELS) {
        double fpr_i = b->fpr;
        for (int i = 0; i <= b->n_levels; i++) fpr_i *= 0.5;
        if (!bloom_level_init(&b->lv[b->n_levels], last->cap * 2, fpr_i)) {
            *oom = 1;
            return 0;
        }
        b->n_levels++;
        last = &b->lv[b->n_levels - 1];
    }
    bloom_level_test(last, b->n_levels - 1, h, 1);
    last->n++;
    return 0;
}

/* ---------- 1. dedup fold ----------
 *
 * Stateful streaming form: sk_fold_new -> sk_fold_push (any number of
 * chunks, read order) -> sk_fold_finish. The one-shot sk_dedup_fold wraps
 * them. State holds the count map, the pair set / bloom, and the
 * first-insertion order list (serialization order parity).
 */

typedef struct {
    Map64 counts;
    Set128 pairs;
    Bloom bloom;
    int use_bloom, no_dedup;
    uint32_t threshold;
    uint64_t *order;
    uint64_t *order_seq;    /* sharded mode: global occurrence index of
                             * each first insertion (merge key) */
    int64_t n_order, order_cap;
    int64_t ndup;
    /* hash-sharded parallel mode (sk_fold_set_shard): this state owns
     * only k-mers with mix64(km) >> shard_shift == shard; every shard
     * receives every push (same arrays) and skips foreign k-mers, so
     * per-key decision sequences are bit-identical to the serial fold
     * (exact pair set only — the bloom filter is shared cross-key
     * state and must stay unsharded). occ_base accumulates pushed
     * occurrences to form global seqnos. */
    int shard;
    int shard_shift;        /* 0 = unsharded; else 64 - log2(n_shards) */
    int64_t occ_base;
    /* per-push scratch (pass 1 materializes per-occurrence hashes and
     * flags so pass 2 can software-prefetch the table lines ~16
     * occurrences ahead — the fold is pure memory latency otherwise) */
    uint64_t *sc_mk, *sc_h0, *sc_h1, *sc_f0, *sc_f1;
    uint8_t *sc_fl;
    int64_t sc_cap;
} FoldState;

/* flags bits in sc_fl */
#define FL_FPVALID 1u
#define FL_SKIP 2u

static int fold_scratch_reserve(FoldState *st, int64_t n) {
    if (n <= st->sc_cap) return 1;
    int64_t cap = st->sc_cap > 0 ? st->sc_cap : (1 << 16);
    while (cap < n) cap *= 2;
    uint64_t *mk = (uint64_t *)realloc(st->sc_mk, cap * sizeof(uint64_t));
    uint64_t *h0 = (uint64_t *)realloc(st->sc_h0, cap * sizeof(uint64_t));
    uint64_t *h1 = (uint64_t *)realloc(st->sc_h1, cap * sizeof(uint64_t));
    uint64_t *f0 = (uint64_t *)realloc(st->sc_f0, cap * sizeof(uint64_t));
    uint64_t *f1 = (uint64_t *)realloc(st->sc_f1, cap * sizeof(uint64_t));
    uint8_t *fl = (uint8_t *)realloc(st->sc_fl, cap);
    if (mk) st->sc_mk = mk;
    if (h0) st->sc_h0 = h0;
    if (h1) st->sc_h1 = h1;
    if (f0) st->sc_f0 = f0;
    if (f1) st->sc_f1 = f1;
    if (fl) st->sc_fl = fl;
    if (!(mk && h0 && h1 && f0 && f1 && fl)) return 0;
    st->sc_cap = cap;
    return 1;
}

void *sk_fold_new(int no_dedup, uint32_t threshold, double fpr) {
    FoldState *st = (FoldState *)calloc(1, sizeof(FoldState));
    if (!st) return NULL;
    st->no_dedup = no_dedup;
    st->threshold = threshold;
    st->use_bloom = (fpr > 0.0) && !no_dedup;
    if (!map_init(&st->counts, 1 << 16) || !set_init(&st->pairs, 1 << 16)) {
        free(st);
        return NULL;
    }
    if (st->use_bloom && !bloom_init(&st->bloom, fpr)) {
        free(st->counts.e);
        free(st->pairs.e);
        free(st);
        return NULL;
    }
    st->order_cap = 1 << 16;
    st->order = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)st->order_cap);
    if (!st->order) return NULL;
    return st;
}

/* Configure hash-sharded mode: this state processes only k-mers whose
 * mix64 lands in its shard. n_shards must be a power of two >= 2; call
 * once, before any push. Returns 0 on OOM/bad args. */
int sk_fold_set_shard(void *p, int shard, int n_shards) {
    FoldState *st = (FoldState *)p;
    int b = 0;
    if (!st || n_shards < 2 || (n_shards & (n_shards - 1))
        || shard < 0 || shard >= n_shards || st->n_order
        || st->use_bloom)
        return 0;
    while ((1 << b) < n_shards) b++;
    st->shard = shard;
    st->shard_shift = 64 - b;
    st->order_seq = (uint64_t *)malloc(sizeof(uint64_t)
                                       * (size_t)st->order_cap);
    return st->order_seq != NULL;
}

/* first-insertion-order key stream accessors: the device ingest path
 * uploads the order array incrementally while decode/seed/fold still
 * run, hiding the sample H2D behind the ingest wall */
int64_t sk_fold_order_count(void *p) {
    return ((FoldState *)p)->n_order;
}

void sk_fold_order_copy(void *p, int64_t start, int64_t end,
                        uint64_t *out) {
    FoldState *st = (FoldState *)p;
    if (end > st->n_order) end = st->n_order;
    if (start < 0 || start >= end) return;
    memcpy(out, st->order + start,
           sizeof(uint64_t) * (size_t)(end - start));
}

/* Presize for an expected number of distinct keys (estimated by the
 * caller from the first decoded block x the file's size ratio): one
 * calloc each instead of a cascade of rehashes. The pair set sees ~2
 * inserts per occurrence (two fingerprint pairs). Never shrinks; safe
 * to call at any point; returns 0 on OOM (state remains usable). */
int sk_fold_reserve(void *p, int64_t n_keys) {
    FoldState *st = (FoldState *)p;
    if (!st || n_keys <= 0) return 1;
    uint64_t want = (uint64_t)n_keys * 10u / 7u + 1u;
    uint64_t cap = 1;
    while (cap < want) cap *= 2;
    if (cap > st->counts.cap && !map_rehash(&st->counts, cap)) return 0;
    if (!st->no_dedup && !st->use_bloom) {
        uint64_t want2 = (uint64_t)n_keys * 20u / 7u + 1u;
        uint64_t cap2 = 1;
        while (cap2 < want2) cap2 *= 2;
        if (cap2 > st->pairs.cap && !set_rehash(&st->pairs, cap2))
            return 0;
    }
    if (n_keys > st->order_cap) {
        uint64_t *no = (uint64_t *)realloc(
            st->order, sizeof(uint64_t) * (size_t)n_keys);
        if (!no) return 0;
        st->order = no;
        if (st->order_seq) {
            uint64_t *ns = (uint64_t *)realloc(
                st->order_seq, sizeof(uint64_t) * (size_t)n_keys);
            if (!ns) return 0;
            st->order_seq = ns;
        }
        st->order_cap = n_keys;
    }
    return 1;
}

void sk_fold_free(void *p) {
    FoldState *st = (FoldState *)p;
    if (!st) return;
    free(st->counts.e);
    free(st->pairs.e);
    if (st->use_bloom) bloom_free(&st->bloom);
    free(st->order);
    free(st->order_seq);
    free(st->sc_mk); free(st->sc_h0); free(st->sc_h1);
    free(st->sc_f0); free(st->sc_f1); free(st->sc_fl);
    free(st);
}

/* Partition one block's occurrences by fold-hash shard for the parallel
 * fold: out_kmers/out_seq lay out shard-major ([shard_base[w],
 * shard_base[w+1]) holds shard w's k-mers in stream order; out_seq holds
 * their ORIGINAL in-block indices — the merge key for global insertion
 * order). Per-shard segment starts are RELATIVE to the shard's base
 * (out_segs[w*n_segs + s]); empty segments are kept so fps/valid/
 * filter_prev arrays are shared with the serial layout. */
void sk_fold_partition(const uint64_t *kmers, int64_t n,
                       const int64_t *seg_starts, int64_t n_segs,
                       int n_shards,
                       uint64_t *out_kmers, int64_t *out_seq,
                       int64_t *out_segs, int64_t *shard_base) {
    int b = 0;
    int64_t cnt[64] = {0};
    int64_t pos[64];
    while ((1 << b) < n_shards) b++;
    int shift = 64 - b;
    int64_t start = n_segs > 0 ? seg_starts[0] : n;
    for (int64_t i = start; i < n; i++)
        cnt[mix64(kmers[i]) >> shift]++;
    shard_base[0] = 0;
    for (int w = 0; w < n_shards; w++) {
        shard_base[w + 1] = shard_base[w] + cnt[w];
        pos[w] = 0;
    }
    for (int64_t s = 0; s < n_segs; s++) {
        int64_t lo = seg_starts[s];
        int64_t hi = (s + 1 < n_segs) ? seg_starts[s + 1] : n;
        for (int w = 0; w < n_shards; w++)
            out_segs[(int64_t)w * n_segs + s] = pos[w];
        for (int64_t i = lo; i < hi; i++) {
            int w = (int)(mix64(kmers[i]) >> shift);
            int64_t d = shard_base[w] + pos[w];
            out_kmers[d] = kmers[i];
            out_seq[d] = i;
            pos[w]++;
        }
    }
}

/* one chunk of segments; returns cumulative ndup, or -1 on OOM.
 *
 * Two passes. Pass 1 (sequential, branch-light) materializes the
 * per-occurrence hashes and flags; pass 2 runs the exact decision
 * sequence of the original per-segment loop, prefetching the count-map
 * and pair-set cache lines PF_DIST occurrences ahead. Segments here are
 * single reads (1-3 surviving k-mers each), so lookahead must cross
 * segment boundaries — hence the flattening. Decisions, insertion
 * order, grows, and ndup are bit-identical to the naive loop. */
#define PF_DIST 32
static int64_t fold_push_impl(FoldState *st, const uint64_t *kmers,
                              int64_t n_kmers,
                              const int64_t *seg_starts, int64_t n_segs,
                              const uint64_t *fp, const uint8_t *fp_valid,
                              const uint8_t *filter_prev,
                              const int64_t *seqs, int64_t occ_advance) {
    int oom = 0;
    if (n_kmers <= 0 || n_segs <= 0) {
        st->occ_base += occ_advance;
        return st->ndup;
    }
    if (!fold_scratch_reserve(st, n_kmers)) return -1;
    uint64_t *mk = st->sc_mk, *h0 = st->sc_h0, *h1 = st->sc_h1;
    uint64_t *f0 = st->sc_f0, *f1 = st->sc_f1;
    uint8_t *fl = st->sc_fl;

    for (int64_t s = 0; s < n_segs; s++) {
        int64_t lo = seg_starts[s];
        int64_t hi = (s + 1 < n_segs) ? seg_starts[s + 1] : n_kmers;
        int64_t plo = 0, phi = 0;
        if (filter_prev && filter_prev[s] && s > 0) {
            plo = seg_starts[s - 1];
            phi = lo;
        }
        uint8_t v = (fp_valid && fp_valid[s]) ? FL_FPVALID : 0;
        uint64_t p0 = 0, p1 = 0, m0 = 0, m1 = 0;
        if (v) {
            p0 = fp[4 * s + 0] << 32 | (uint32_t)fp[4 * s + 1];
            p1 = fp[4 * s + 2] << 32 | (uint32_t)fp[4 * s + 3];
            m0 = mix64(p0 * 0x9e3779b97f4a7c15ULL);
            m1 = mix64(p1 * 0x9e3779b97f4a7c15ULL);
        }
        for (int64_t i = lo; i < hi; i++) {
            uint64_t km = kmers[i];
            uint8_t flags = v;
            uint64_t h = mix64(km);
            if (st->shard_shift
                && (h >> st->shard_shift) != (uint64_t)st->shard) {
                fl[i] = flags | FL_SKIP; /* foreign shard's k-mer: flag
                                          * only — skipping the 40 B of
                                          * scratch writes keeps the W-way
                                          * fold's aggregate memory
                                          * traffic near the serial
                                          * fold's */
                continue;
            }
            if (phi > plo) {            /* present in previous segment? */
                for (int64_t j = plo; j < phi; j++)
                    if (kmers[j] == km) { flags |= FL_SKIP; break; }
            }
            mk[i] = h;
            h0[i] = h ^ m0;
            h1[i] = h ^ m1;
            f0[i] = p0;
            f1[i] = p1;
            fl[i] = flags;
        }
    }

    /* pass 1 only initialized scratch for indices covered by segments;
     * start pass 2 at the first covered index so a caller with
     * seg_starts[0] != 0 can't fold through uninitialized scratch */
    for (int64_t i = seg_starts[0]; i < n_kmers; i++) {
        if (i + PF_DIST < n_kmers && !(fl[i + PF_DIST] & FL_SKIP)) {
            int64_t pf = i + PF_DIST;
            __builtin_prefetch(
                &st->counts.e[mk[pf] & (st->counts.cap - 1)]);
            if (!st->no_dedup && (fl[pf] & FL_FPVALID)) {
                if (st->use_bloom) {
                    const BloomLevel *l0 = &st->bloom.lv[0];
                    uint64_t hh = mix64(h0[pf] + 1);
                    __builtin_prefetch(l0->bits + 8 * (uint64_t)(
                        ((__uint128_t)hh * l0->n_blocks) >> 64));
                } else {
                    uint64_t smask = st->pairs.cap - 1;
                    __builtin_prefetch(&st->pairs.e[h0[pf] & smask]);
                    __builtin_prefetch(&st->pairs.e[h1[pf] & smask]);
                }
            }
        }
        if (fl[i] & FL_SKIP) continue;
        uint64_t km = kmers[i];
        int64_t slot = map_slot_h(&st->counts, mk[i], km);
        uint32_t c = st->counts.e[slot].used ? st->counts.e[slot].val : 0;
        if (!st->no_dedup && c < st->threshold && (fl[i] & FL_FPVALID)) {
            int ret = 0;
            int in0 = st->use_bloom
                ? bloom_check_insert_h(&st->bloom, h0[i], &oom)
                : set_check_insert_h(&st->pairs, h0[i], km, f0[i], &oom);
            if (in0 && c > 0) ret = 1;
            int in1 = st->use_bloom
                ? bloom_check_insert_h(&st->bloom, h1[i], &oom)
                : set_check_insert_h(&st->pairs, h1[i], km, f1[i], &oom);
            if (in1 && c > 0) ret = 1;
            if (ret) { st->ndup++; continue; }
        }
        if (!st->counts.e[slot].used) {
            st->counts.e[slot].used = 1;
            st->counts.e[slot].key = km;
            st->counts.e[slot].val = 1;
            st->counts.n++;
            if (st->n_order >= st->order_cap) {
                st->order_cap *= 2;
                uint64_t *no = (uint64_t *)realloc(
                    st->order,
                    sizeof(uint64_t) * (size_t)st->order_cap);
                if (!no) { oom = 1; break; }
                st->order = no;
                if (st->order_seq) {
                    uint64_t *ns = (uint64_t *)realloc(
                        st->order_seq,
                        sizeof(uint64_t) * (size_t)st->order_cap);
                    if (!ns) { oom = 1; break; }
                    st->order_seq = ns;
                }
            }
            if (st->order_seq)
                st->order_seq[st->n_order] =
                    (uint64_t)(st->occ_base + (seqs ? seqs[i] : i));
            st->order[st->n_order++] = km;
            if (st->counts.n * 10 > st->counts.cap * 7) {
                if (!map_grow(&st->counts)) { oom = 1; break; }
            }
        } else {
            st->counts.e[slot].val = c + 1;
        }
        if (oom) break;
    }
    st->occ_base += occ_advance;    /* original block span, so global
                                     * seqnos stay aligned across shards */
    return oom ? -1 : st->ndup;
}

int64_t sk_fold_push(void *p, const uint64_t *kmers, int64_t n_kmers,
                     const int64_t *seg_starts, int64_t n_segs,
                     const uint64_t *fp, const uint8_t *fp_valid,
                     const uint8_t *filter_prev) {
    return fold_push_impl((FoldState *)p, kmers, n_kmers, seg_starts,
                          n_segs, fp, fp_valid, filter_prev, NULL,
                          n_kmers);
}

/* pre-partitioned push (sk_fold_partition layout): kmers/seg_starts are
 * one shard's compacted slice, seqs its original in-block indices, and
 * occ_advance the ORIGINAL block's occurrence count. */
int64_t sk_fold_push_seq(void *p, const uint64_t *kmers, int64_t n_kmers,
                         const int64_t *seg_starts, int64_t n_segs,
                         const uint64_t *fp, const uint8_t *fp_valid,
                         const uint8_t *filter_prev,
                         const int64_t *seqs, int64_t occ_advance) {
    return fold_push_impl((FoldState *)p, kmers, n_kmers, seg_starts,
                          n_segs, fp, fp_valid, filter_prev, seqs,
                          occ_advance);
}

/* ---- hash-sharded merge: W disjoint shard states -> one stream ----
 *
 * Shard seqnos (global first-insertion occurrence indices) are strictly
 * increasing within each state, so the global first-insertion order is
 * a W-way merge by seqno. Keys are disjoint across shards. */

/* merge the [starts[i], ends[i]) order slices of each state by seqno
 * into out; returns merged count (used for incremental per-push key
 * streaming — new_keys — in the parallel fold) */
int64_t sk_fold_merge_order(void **states, int n_states,
                            const int64_t *starts, const int64_t *ends,
                            uint64_t *out) {
    int64_t pos[64];
    int64_t t = 0;
    if (n_states > 64) return -1;
    for (int s = 0; s < n_states; s++) pos[s] = starts[s];
    for (;;) {
        int best = -1;
        uint64_t bseq = 0;
        for (int s = 0; s < n_states; s++) {
            FoldState *st = (FoldState *)states[s];
            if (pos[s] >= ends[s] || pos[s] >= st->n_order) continue;
            uint64_t sq = st->order_seq[pos[s]];
            if (best < 0 || sq < bseq) { best = s; bseq = sq; }
        }
        if (best < 0) break;
        out[t++] = ((FoldState *)states[best])->order[pos[best]];
        pos[best]++;
    }
    return t;
}

/* emit the merged (kmers, counts) of all shard states in global
 * first-insertion order; returns summed ndup or -1 on OOM */
int64_t sk_fold_merge_finish(void **states, int n_states,
                             uint64_t **out_kmers, uint32_t **out_counts,
                             int64_t *out_n) {
    int64_t pos[64];
    int64_t total = 0, ndup = 0, t = 0;
    if (n_states > 64) return -1;
    for (int s = 0; s < n_states; s++) {
        FoldState *st = (FoldState *)states[s];
        if (!st->order_seq && st->n_order) return -1;
        total += st->n_order;
        ndup += st->ndup;
        pos[s] = 0;
    }
    uint64_t *ok = (uint64_t *)malloc(sizeof(uint64_t)
                                      * (size_t)(total > 0 ? total : 1));
    uint32_t *oc = (uint32_t *)malloc(sizeof(uint32_t)
                                      * (size_t)(total > 0 ? total : 1));
    if (!ok || !oc) { free(ok); free(oc); return -1; }
    for (;;) {
        int best = -1;
        uint64_t bseq = 0;
        for (int s = 0; s < n_states; s++) {
            FoldState *st = (FoldState *)states[s];
            if (pos[s] >= st->n_order) continue;
            uint64_t sq = st->order_seq[pos[s]];
            if (best < 0 || sq < bseq) { best = s; bseq = sq; }
        }
        if (best < 0) break;
        FoldState *st = (FoldState *)states[best];
        int64_t i = pos[best]++;
        if (i + PF_DIST < st->n_order)
            __builtin_prefetch(&st->counts.e[
                mix64(st->order[i + PF_DIST]) & (st->counts.cap - 1)]);
        uint64_t km = st->order[i];
        ok[t] = km;
        oc[t] = st->counts.e[map_slot(&st->counts, km)].val;
        t++;
    }
    *out_kmers = ok;
    *out_counts = oc;
    *out_n = t;
    return ndup;
}

/* emit (kmers, counts) in first-insertion order; state stays valid */
int64_t sk_fold_finish(void *p, uint64_t **out_kmers, uint32_t **out_counts,
                       int64_t *out_n) {
    FoldState *st = (FoldState *)p;
    int64_t n = st->n_order;
    uint64_t *ok = (uint64_t *)malloc(sizeof(uint64_t)
                                      * (size_t)(n > 0 ? n : 1));
    uint32_t *oc = (uint32_t *)malloc(sizeof(uint32_t)
                                      * (size_t)(n > 0 ? n : 1));
    if (!ok || !oc) { free(ok); free(oc); return -1; }
    uint64_t mmask = st->counts.cap - 1;
    for (int64_t i = 0; i < n; i++) {
        if (i + PF_DIST < n)
            __builtin_prefetch(
                &st->counts.e[mix64(st->order[i + PF_DIST]) & mmask]);
        ok[i] = st->order[i];
        oc[i] = st->counts.e[map_slot(&st->counts, st->order[i])].val;
    }
    *out_kmers = ok;
    *out_counts = oc;
    *out_n = n;
    return st->ndup;
}

/* Segments are runs of k-mers sharing one dedup decision context (one read,
 * or one mate of a pair). Per segment:
 *   fp_valid[s]: fingerprint present (read length gates)
 *   fp[4*s..4*s+4): the two (u32,u32) fingerprint pairs packed as
 *                   fp0 = (f << 32 | r), fp1 = (g << 32 | t) — each pair is
 *                   one 64-bit unit; dedup keys are (kmer, fp_pair)
 *   filter_prev[s]: skip k-mers present in the previous segment (paired R2
 *                   vs same-pair R1, sylph src/sketch.rs:851-853)
 * threshold: dedup consulted only while count < threshold (single-end
 * MAX_DEDUP_COUNT=4; pass UINT32_MAX for paired).
 * fpr: 0 => exact pair set; > 0 => scalable blocked-bloom bounded at that
 * total false-positive probability (reference src/sketch.rs:830-846).
 */

/* ---------- 2. genome spacing scan ---------- */

/* kept/tracked must be zero-initialized by the caller (numpy zeros).
 * Mirrors sylph src/sketch.rs:602-614 (whole-genome) / :510-531
 * (per_contig=1: no reset on contig change). */
void sk_spacing_scan(const int64_t *contigs, const int64_t *positions,
                     int64_t n, int64_t min_spacing, int per_contig,
                     int pseudotax, uint8_t *kept, uint8_t *tracked) {
    int64_t last_pos = 0, last_contig = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t pos = positions[i];
        if (last_pos == 0
            || (!per_contig && last_contig != contigs[i])
            || pos - last_pos > min_spacing) {
            kept[i] = 1;
            last_contig = contigs[i];
            last_pos = pos;
        } else if (pseudotax) {
            tracked[i] = 1;
        }
    }
}

/* ---------- 3. scalar FracMinHash seeding ----------
 *
 * The rolling canonical-k-mer loop over 2-bit codes (spec: sylph
 * src/seeding.rs:86-146 fmh_seeds / :182-208 fmh_seeds_positions), with
 * the reference's deliberately bugged Wang mix first step
 * ~(key + (key<<21)) (src/seeding.rs:4-15). Operates on already-encoded
 * codes (values 0..3) — identical to byte input because BYTE_TO_SEQ maps
 * 0x00-0x03 to 0..3. The host-side seeding hot path: ~10 ns/base vs
 * ~100 ns/base for the vectorized-numpy log-doubling composition.
 */

static inline uint64_t sx_hash64(uint64_t key) {
    key = ~(key + (key << 21));               /* the preserved bug */
    key ^= key >> 24;
    key = key + (key << 3) + (key << 8);      /* * 265 */
    key ^= key >> 14;
    key = key + (key << 2) + (key << 4);      /* * 21 */
    key ^= key >> 28;
    key = key + (key << 31);
    return key;
}

typedef struct { void *p; size_t cap, n, elt; } Vec;

static int vec_init(Vec *v, size_t cap, size_t elt) {
    v->p = malloc(cap * elt);
    v->cap = cap;
    v->n = 0;
    v->elt = elt;
    return v->p != NULL;
}

static inline int vec_reserve(Vec *v, size_t extra) {
    if (v->n + extra <= v->cap) return 1;
    while (v->n + extra > v->cap) v->cap *= 2;
    void *np_ = realloc(v->p, v->cap * v->elt);
    if (!np_) return 0;
    v->p = np_;
    return 1;
}

/* survivors of all records, (rid, hash) pairs in (read, position) order */
/* scalar seeding of codes[s:e) from roll state (f, rc), starting at the
 * window whose last base is index s + done (done >= 0 bases already
 * consumed). Appends survivor hashes to hv (and rid to rv when rv is
 * non-NULL; and position pos_base + (i - s) to pv when pv is non-NULL).
 * Returns 0 on allocation failure. */
static int sx_seed_tail(const uint8_t *codes, int64_t s, int64_t e,
                        int64_t done, uint64_t f, uint64_t rc,
                        uint64_t thr, uint64_t mask, uint64_t rev_mask,
                        int rshift, int k, Vec *rv, Vec *pv, Vec *hv,
                        int64_t rid, int64_t pos_base) {
    int64_t i = s + done;
    for (; i < s + k - 1; i++) {            /* still warming up */
        uint64_t nf = codes[i];
        f = (f << 2) | nf;
        rc = (rc >> 2) | ((3 - nf) << rshift);
    }
    for (; i < e; i++) {
        uint64_t nf = codes[i];
        f = ((f << 2) | nf) & mask;
        rc = ((rc >> 2) & rev_mask) | ((3 - nf) << rshift);
        uint64_t canon = f < rc ? f : rc;
        uint64_t h = sx_hash64(canon);
        if (h < thr) {
            if (!vec_reserve(&hv[0], 1)) return 0;
            if (rv && !vec_reserve(&rv[0], 1)) return 0;
            if (pv && !vec_reserve(&pv[0], 1)) return 0;
            if (rv) ((int64_t *)rv->p)[rv->n++] = rid;
            if (pv) ((int64_t *)pv->p)[pv->n++] = pos_base + (i - s);
            ((uint64_t *)hv->p)[hv->n++] = h;
        }
    }
    return 1;
}

#if defined(__x86_64__) && defined(__GNUC__)
#define SX_HAVE_AVX2_BUILD 1
#include <immintrin.h>

__attribute__((target("avx2")))
static inline __m256i sx_hash4(__m256i key) {
    /* 4-lane mm_hash64 with the preserved first-step bug */
    const __m256i ones = _mm256_set1_epi64x(-1LL);
    key = _mm256_xor_si256(
        _mm256_add_epi64(key, _mm256_slli_epi64(key, 21)), ones);
    key = _mm256_xor_si256(key, _mm256_srli_epi64(key, 24));
    key = _mm256_add_epi64(_mm256_add_epi64(key, _mm256_slli_epi64(key, 3)),
                           _mm256_slli_epi64(key, 8));
    key = _mm256_xor_si256(key, _mm256_srli_epi64(key, 14));
    key = _mm256_add_epi64(_mm256_add_epi64(key, _mm256_slli_epi64(key, 2)),
                           _mm256_slli_epi64(key, 4));
    key = _mm256_xor_si256(key, _mm256_srli_epi64(key, 28));
    key = _mm256_add_epi64(key, _mm256_slli_epi64(key, 31));
    return key;
}

__attribute__((target("avx2")))
static inline __m256i sx_ltu4(__m256i a, __m256i b) {   /* unsigned a < b */
    const __m256i bias = _mm256_set1_epi64x((long long)0x8000000000000000ULL);
    return _mm256_cmpgt_epi64(_mm256_xor_si256(b, bias),
                              _mm256_xor_si256(a, bias));
}

#define SX_LANE_CAP 2048

/* 4 independent reads, one per 64-bit lane (NOT the reference's
 * split-one-sequence layout, src/avx2_seeding.rs — reads are natural
 * lanes for short-read samples and need no chunk-seam handling). The
 * lockstep vector loop runs while every lane still has 8 unread bases;
 * per-lane scalar tails finish from the extracted roll state. Survivors
 * land in per-lane buffers so global (read, position) order is restored
 * by appending lane-by-lane. Returns 1 on success, 0 when a lane buffer
 * overflows (caller redoes the quad scalar), -1 on alloc failure. */
__attribute__((target("avx2")))
static int sx_seed_quad_avx2(const uint8_t *codes, const int64_t *starts,
                             const int64_t *ends, const int64_t *rids,
                             uint64_t c, int k, uint64_t thr,
                             uint64_t mask, uint64_t rev_mask, int rshift,
                             Vec *rv, Vec *hv,
                             uint64_t (*hbuf)[SX_LANE_CAP]) {
    int64_t minlen = ends[0] - starts[0];
    for (int l = 1; l < 4; l++) {
        int64_t len = ends[l] - starts[l];
        if (len < minlen) minlen = len;
    }
    int n_l[4] = {0, 0, 0, 0};
    __m256i f = _mm256_setzero_si256(), rc = _mm256_setzero_si256();
    const __m256i vmask = _mm256_set1_epi64x((long long)mask);
    const __m256i vthr = _mm256_set1_epi64x((long long)thr);
    const __m256i three = _mm256_set1_epi64x(3);
    const __m256i vidx0 = _mm256_setr_epi64x(
        (long long)starts[0], (long long)starts[1],
        (long long)starts[2], (long long)starts[3]);
    int64_t j = 0;
    for (; j + 8 <= minlen; j += 8) {
        __m256i g = _mm256_i64gather_epi64(
            (const long long *)codes,
            _mm256_add_epi64(vidx0, _mm256_set1_epi64x((long long)j)), 1);
        for (int t = 0; t < 8; t++) {
            __m256i b = _mm256_and_si256(
                _mm256_srli_epi64(g, 8 * t), three);
            f = _mm256_and_si256(
                _mm256_or_si256(_mm256_slli_epi64(f, 2), b), vmask);
            rc = _mm256_or_si256(
                _mm256_srli_epi64(rc, 2),
                _mm256_slli_epi64(_mm256_xor_si256(b, three), rshift));
            if (j + t < k - 1) continue;     /* rolls still warming up */
            __m256i canon = _mm256_blendv_epi8(f, rc, sx_ltu4(rc, f));
            __m256i h = sx_hash4(canon);
            int mm = _mm256_movemask_epi8(sx_ltu4(h, vthr));
            if (mm) {
                uint64_t hs[4];
                _mm256_storeu_si256((__m256i *)hs, h);
                for (int l = 0; l < 4; l++) {
                    if ((mm >> (8 * l)) & 1) {
                        if (n_l[l] >= SX_LANE_CAP) return 0;
                        hbuf[l][n_l[l]++] = hs[l];
                    }
                }
            }
        }
    }
    uint64_t fs[4], rcs[4];
    _mm256_storeu_si256((__m256i *)fs, f);
    _mm256_storeu_si256((__m256i *)rcs, rc);
    for (int l = 0; l < 4; l++) {
        /* append the vector-phase survivors, then finish scalar */
        if (!vec_reserve(rv, (size_t)n_l[l] + 1)
                || !vec_reserve(hv, (size_t)n_l[l] + 1)) return -1;
        for (int i = 0; i < n_l[l]; i++) {
            ((int64_t *)rv->p)[rv->n++] = rids[l];
            ((uint64_t *)hv->p)[hv->n++] = hbuf[l][i];
        }
        if (ends[l] - starts[l] < (int64_t)k) continue;
        if (!sx_seed_tail(codes, starts[l], ends[l], j,
                          fs[l] & mask, rcs[l], thr, mask, rev_mask,
                          rshift, k, rv, NULL, hv, rids[l], 0))
            return -1;
    }
    return 1;
}

static int sx_avx2_ok(void) {
    static int ok = -1;
    if (ok < 0) ok = __builtin_cpu_supports("avx2") ? 1 : 0;
    return ok;
}

__attribute__((target("avx512f")))
static inline __m512i sx_hash8(__m512i key) {
    key = _mm512_xor_si512(                     /* ~(key + (key << 21)) */
        _mm512_add_epi64(key, _mm512_slli_epi64(key, 21)),
        _mm512_set1_epi64(-1LL));
    key = _mm512_xor_si512(key, _mm512_srli_epi64(key, 24));
    key = _mm512_add_epi64(_mm512_add_epi64(key, _mm512_slli_epi64(key, 3)),
                           _mm512_slli_epi64(key, 8));
    key = _mm512_xor_si512(key, _mm512_srli_epi64(key, 14));
    key = _mm512_add_epi64(_mm512_add_epi64(key, _mm512_slli_epi64(key, 2)),
                           _mm512_slli_epi64(key, 4));
    key = _mm512_xor_si512(key, _mm512_srli_epi64(key, 28));
    key = _mm512_add_epi64(key, _mm512_slli_epi64(key, 31));
    return key;
}

/* 8 independent sequences per zmm lane; same structure as the AVX2 quad
 * (lockstep vector phase + scalar tails), with native unsigned compares
 * (_mm512_cmplt_epu64_mask), min_epu64 canonicalization and mask-register
 * survivor extraction. Lanes are whole reads (reads path: pv == NULL) or
 * halo'd stripes of one record (genome-positions path: pv != NULL,
 * pos_base[l] maps a lane-local window-end index to the in-record
 * position). */
__attribute__((target("avx512f")))
static int sx_seed_oct_avx512(const uint8_t *codes, const int64_t *starts,
                              const int64_t *ends, const int64_t *rids,
                              uint64_t c, int k, uint64_t thr,
                              uint64_t mask, uint64_t rev_mask, int rshift,
                              Vec *rv, Vec *pv, Vec *hv,
                              uint64_t (*hbuf)[SX_LANE_CAP],
                              uint32_t (*pbuf)[SX_LANE_CAP],
                              const int64_t *pos_base) {
    int64_t minlen = ends[0] - starts[0];
    for (int l = 1; l < 8; l++) {
        int64_t len = ends[l] - starts[l];
        if (len < minlen) minlen = len;
    }
    int n_l[8] = {0};
    __m512i f = _mm512_setzero_si512(), rc = _mm512_setzero_si512();
    const __m512i vmask = _mm512_set1_epi64((long long)mask);
    const __m512i vthr = _mm512_set1_epi64((long long)thr);
    const __m512i three = _mm512_set1_epi64(3);
    const __m512i vidx0 = _mm512_loadu_si512((const void *)starts);
    int64_t j = 0;
    for (; j + 8 <= minlen; j += 8) {
        __m512i g = _mm512_i64gather_epi64(
            _mm512_add_epi64(vidx0, _mm512_set1_epi64((long long)j)),
            (const void *)codes, 1);
        for (int t = 0; t < 8; t++) {
            __m512i b = _mm512_and_si512(_mm512_srli_epi64(g, 8 * t),
                                         three);
            f = _mm512_and_si512(
                _mm512_or_si512(_mm512_slli_epi64(f, 2), b), vmask);
            rc = _mm512_or_si512(
                _mm512_srli_epi64(rc, 2),
                _mm512_slli_epi64(_mm512_xor_si512(b, three), rshift));
            if (j + t < k - 1) continue;
            __m512i h = sx_hash8(_mm512_min_epu64(f, rc));
            __mmask8 mm = _mm512_cmplt_epu64_mask(h, vthr);
            if (mm) {
                uint64_t hs[8];
                _mm512_storeu_si512((void *)hs, h);
                for (int l = 0; l < 8; l++) {
                    if ((mm >> l) & 1) {
                        if (n_l[l] >= SX_LANE_CAP) return 0;
                        if (pbuf) pbuf[l][n_l[l]] = (uint32_t)(j + t);
                        hbuf[l][n_l[l]++] = hs[l];
                    }
                }
            }
        }
    }
    uint64_t fs[8], rcs[8];
    _mm512_storeu_si512((void *)fs, f);
    _mm512_storeu_si512((void *)rcs, rc);
    for (int l = 0; l < 8; l++) {
        if (!vec_reserve(rv, (size_t)n_l[l] + 1)
                || !vec_reserve(hv, (size_t)n_l[l] + 1)
                || (pv && !vec_reserve(pv, (size_t)n_l[l] + 1)))
            return -1;
        for (int i = 0; i < n_l[l]; i++) {
            ((int64_t *)rv->p)[rv->n++] = rids[l];
            if (pv)
                ((int64_t *)pv->p)[pv->n++] = pos_base[l]
                    + (int64_t)pbuf[l][i];
            ((uint64_t *)hv->p)[hv->n++] = hbuf[l][i];
        }
        if (ends[l] - starts[l] < (int64_t)k) continue;
        if (!sx_seed_tail(codes, starts[l], ends[l], j,
                          fs[l] & mask, rcs[l], thr, mask, rev_mask,
                          rshift, k, rv, pv, hv, rids[l],
                          pos_base ? pos_base[l] : 0)) return -1;
    }
    return 1;
}

static int sx_avx512_ok(void) {
    static int ok = -1;
    if (ok < 0) {
        const char *env = getenv("SYLPH_NO_AVX512");
        ok = (!env && __builtin_cpu_supports("avx512f")) ? 1 : 0;
    }
    return ok;
}
#endif /* x86_64 */

int64_t sx_seed_concat(const uint8_t *codes, const int64_t *starts,
                       const int64_t *ends, int64_t n_rec,
                       uint64_t c, int k,
                       int64_t **out_rids, uint64_t **out_hashes) {
    uint64_t thr = UINT64_MAX / c;
    uint64_t mask = UINT64_MAX >> (64 - 2 * k);
    uint64_t rev_mask = ~(3ULL << (2 * k - 2));
    int rshift = 2 * (k - 1);
    int64_t total = n_rec ? ends[n_rec - 1] - starts[0] : 0;
    Vec rv, hv;
    if (!vec_init(&rv, (size_t)(total / (int64_t)c + 1024),
                  sizeof(int64_t))) return -1;
    if (!vec_init(&hv, rv.cap, sizeof(uint64_t))) { free(rv.p); return -1; }
    int64_t r = 0;
#ifdef SX_HAVE_AVX2_BUILD
    if (sx_avx2_ok() || sx_avx512_ok()) {
        static __thread uint64_t hbuf[8][SX_LANE_CAP];
        int W = sx_avx512_ok() ? 8 : 4;
        for (; r + W <= n_rec; r += W) {
            int64_t minlen = ends[r] - starts[r];
            int64_t maxlen = minlen;
            for (int l = 1; l < W; l++) {
                int64_t len = ends[r + l] - starts[r + l];
                if (len < minlen) minlen = len;
                if (len > maxlen) maxlen = len;
            }
            /* vectorize only when the lockstep phase covers the warmup
             * for every lane and no lane can overflow its buffer */
            int rcq = 0;
            if (minlen >= (int64_t)k + 8
                    && maxlen / (int64_t)c + 64 < SX_LANE_CAP) {
                int64_t rids_w[8];
                for (int l = 0; l < W; l++) rids_w[l] = r + l;
                size_t rv_n = rv.n, hv_n = hv.n;
                rcq = W == 8
                    ? sx_seed_oct_avx512(codes, starts + r, ends + r,
                                         rids_w, c, k, thr, mask,
                                         rev_mask, rshift, &rv, NULL,
                                         &hv, hbuf, NULL, NULL)
                    : sx_seed_quad_avx2(codes, starts + r, ends + r,
                                        rids_w, c, k, thr, mask, rev_mask,
                                        rshift, &rv, &hv, hbuf);
                if (rcq < 0) { free(rv.p); free(hv.p); return -1; }
                if (rcq == 0) { rv.n = rv_n; hv.n = hv_n; }
            }
            if (rcq != 1) {
                for (int l = 0; l < W; l++) {
                    if (ends[r + l] - starts[r + l] < (int64_t)k) continue;
                    if (!sx_seed_tail(codes, starts[r + l], ends[r + l],
                                      0, 0, 0, thr, mask, rev_mask,
                                      rshift, k, &rv, NULL, &hv, r + l,
                                      0)) {
                        free(rv.p); free(hv.p); return -1;
                    }
                }
            }
        }
    }
#endif
    for (; r < n_rec; r++) {
        int64_t s = starts[r], e = ends[r];
        if (e - s < (int64_t)k) continue;
        if (!sx_seed_tail(codes, s, e, 0, 0, 0, thr, mask, rev_mask,
                          rshift, k, &rv, NULL, &hv, r, 0)) {
            free(rv.p); free(hv.p); return -1;
        }
    }
    *out_rids = (int64_t *)rv.p;
    *out_hashes = (uint64_t *)hv.p;
    return (int64_t)hv.n;
}

/* genome path: (contig_id, window END position, hash) per survivor */
int64_t sx_seed_positions(const uint8_t *codes, const int64_t *starts,
                          const int64_t *ends, int64_t n_rec,
                          uint64_t c, int k,
                          int64_t **out_cids, int64_t **out_pos,
                          uint64_t **out_hashes) {
    uint64_t thr = UINT64_MAX / c;
    uint64_t mask = UINT64_MAX >> (64 - 2 * k);
    uint64_t rev_mask = ~(3ULL << (2 * k - 2));
    int rshift = 2 * (k - 1);
    int64_t total = n_rec ? ends[n_rec - 1] - starts[0] : 0;
    Vec cv, pv, hv;
    size_t cap0 = (size_t)(total / (int64_t)c + 1024);
    if (!vec_init(&cv, cap0, sizeof(int64_t))) return -1;
    if (!vec_init(&pv, cap0, sizeof(int64_t))) { free(cv.p); return -1; }
    if (!vec_init(&hv, cap0, sizeof(uint64_t))) {
        free(cv.p); free(pv.p); return -1;
    }
    for (int64_t r = 0; r < n_rec; r++) {
        int64_t s = starts[r], e = ends[r];
        if (e - s < (int64_t)k) continue;
        int64_t done_w = 0;              /* window ordinals emitted so far */
        int64_t nwin = (e - s) - (int64_t)k + 1;
#ifdef SX_HAVE_AVX2_BUILD
        /* long contigs: 8 halo'd stripes of SEGWIN windows per oct call
         * (each stripe re-reads its (k-1)-base halo, the same seam
         * treatment as the device genome scan). Positions come back
         * exact, so output order matches the scalar loop. */
        if (sx_avx512_ok()) {
            static __thread uint64_t hbuf[8][SX_LANE_CAP];
            static __thread uint32_t pbuf[8][SX_LANE_CAP];
            const int64_t SEGWIN = 4096;
            /* stripe survivors are binomial(SEGWIN + k, 1/c): cap safe
             * unless c is tiny or the data is adversarial; the kernel
             * reports overflow and the stripe group redoes scalar */
            if ((SEGWIN + (int64_t)k) / (int64_t)c + 64 < SX_LANE_CAP) {
                while (nwin - done_w >= 8 * SEGWIN) {
                    int64_t st[8], en[8], rid8[8], pb[8];
                    for (int l = 0; l < 8; l++) {
                        int64_t w0 = done_w + l * SEGWIN;
                        st[l] = s + w0;
                        en[l] = s + w0 + SEGWIN + (int64_t)k - 1;
                        rid8[l] = r;
                        pb[l] = w0;       /* pos = w0 + lane-local index */
                    }
                    size_t cn = cv.n, pn = pv.n, hn = hv.n;
                    int rcq = sx_seed_oct_avx512(
                        codes, st, en, rid8, c, k, thr, mask, rev_mask,
                        rshift, &cv, &pv, &hv, hbuf, pbuf, pb);
                    if (rcq < 0) {
                        free(cv.p); free(pv.p); free(hv.p); return -1;
                    }
                    if (rcq == 0) {       /* lane overflow: scalar redo */
                        cv.n = cn; pv.n = pn; hv.n = hn;
                        if (!sx_seed_tail(codes, s + done_w, en[7], 0,
                                          0, 0, thr, mask, rev_mask,
                                          rshift, k, &cv, &pv, &hv, r,
                                          done_w)) {
                            free(cv.p); free(pv.p); free(hv.p);
                            return -1;
                        }
                    }
                    done_w += 8 * SEGWIN;
                }
            }
        }
#endif
        /* scalar remainder (whole record when SIMD is unavailable) */
        if (done_w < nwin) {
            if (!sx_seed_tail(codes, s + done_w, e, 0, 0, 0, thr, mask,
                              rev_mask, rshift, k, &cv, &pv, &hv, r,
                              done_w)) {
                free(cv.p); free(pv.p); free(hv.p); return -1;
            }
        }
    }
    *out_cids = (int64_t *)cv.p;
    *out_pos = (int64_t *)pv.p;
    *out_hashes = (uint64_t *)hv.p;
    return (int64_t)hv.n;
}

/* ---------- 4. mean read length fold and fingerprints ---------- */

/* The reference's sequential running mean (sylph src/sketch.rs:941-943):
 * mean += (len - mean) / counter. Bit-exact f64 op order. */
double sk_mean_fold(const int64_t *lengths, int64_t n) {
    double mean = 0.0, counter = 0.0;
    for (int64_t i = 0; i < n; i++) {
        counter += 1.0;
        mean += ((double)lengths[i] - mean) / counter;
    }
    return mean;
}

/* pair_kmer_single fingerprints (sylph src/sketch.rs:624-656): for each
 * selected read, four MSB-first 16-mers packed from 16 even offsets at
 * read start, start+len/2, start+1 and start+1+len/2; valid only for
 * 66 <= len <= 400 (the dedup gate, src/sketch.rs:922-927). One
 * cache-friendly pass per read replaces 64 strided numpy gathers. */
void sx_fp_single(const uint8_t *codes, const int64_t *starts,
                  const int64_t *lengths, const int64_t *rids, int64_t n,
                  uint64_t *out_fps /* [n,4] */, uint8_t *out_valid) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = rids[i];
        int64_t len = lengths[r];
        uint64_t *o = out_fps + 4 * i;
        o[0] = o[1] = o[2] = o[3] = 0;
        out_valid[i] = 0;
        if (len < 66 || len > 400) continue;
        const uint8_t *a = codes + starts[r];
        const uint8_t *b = a + len / 2;
        uint64_t f = 0, rv = 0, g = 0, t = 0;
        for (int j = 0; j < 32; j += 2) {
            f  = (f  << 2) | a[j];
            rv = (rv << 2) | b[j];
            g  = (g  << 2) | a[j + 1];
            t  = (t  << 2) | b[j + 1];
        }
        o[0] = f; o[1] = rv; o[2] = g; o[3] = t;
        out_valid[i] = 1;
    }
}

/* pair_kmer fingerprints (sylph src/sketch.rs:658-688): the four 16-mers
 * come from the two mates (R1 offsets 0/1, R2 offsets 0/1); valid only
 * when both mates are >= 33 bp. */
void sx_fp_paired(const uint8_t *codes1, const int64_t *starts1,
                  const int64_t *lengths1, const uint8_t *codes2,
                  const int64_t *starts2, const int64_t *lengths2,
                  const int64_t *rids, int64_t n,
                  uint64_t *out_fps /* [n,4] */, uint8_t *out_valid) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = rids[i];
        uint64_t *o = out_fps + 4 * i;
        o[0] = o[1] = o[2] = o[3] = 0;
        out_valid[i] = 0;
        if (lengths1[r] < 33 || lengths2[r] < 33) continue;
        const uint8_t *a = codes1 + starts1[r];
        const uint8_t *b = codes2 + starts2[r];
        uint64_t f = 0, rv = 0, g = 0, t = 0;
        for (int j = 0; j < 32; j += 2) {
            f  = (f  << 2) | a[j];
            rv = (rv << 2) | b[j];
            g  = (g  << 2) | a[j + 1];
            t  = (t  << 2) | b[j + 1];
        }
        o[0] = f; o[1] = rv; o[2] = g; o[3] = t;
        out_valid[i] = 1;
    }
}

void sk_free(void *p) { free(p); }
