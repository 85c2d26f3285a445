/* Native FASTX decode + 2-bit packing.
 *
 * The host-side equivalent of the reference's needletail + flate2 stack
 * (sylph src/sketch.rs:780-781, 897-913): parse a decompressed
 * FASTA/FASTQ block and emit
 *   - codes:  2-bit base codes of all records, concatenated
 *             (A/a=0 C/c=1 G/g=2 T/t/U/u=3, everything else 0 — the exact
 *              BYTE_TO_SEQ table of sylph src/types.rs:50-59)
 *   - starts/ends: per-record [start, end) offsets into codes
 *   - names: '\n'-joined header ids (full line after '>'/'@')
 *
 * Exposed as a plain C ABI for ctypes (no CPython dependency). Arrays are
 * malloc'd here and freed with fx_free(). A trimmed copy of the JAX
 * package's native/fastxio.c for sylph_tpu_torch (io/native.py): the
 * whole-file gzip reader is left out (the port decodes gzip in Python), so
 * it needs no zlib.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct FxResult {
    uint8_t *codes;
    int64_t n_codes;
    int64_t *starts;
    int64_t *ends;
    int64_t n_records;
    char *names;
    int64_t names_len;
    char *error; /* NULL on success */
} FxResult;

/* A constant table: parse workers run concurrently from their first call,
 * and a table filled at first use (memset, then the entries) could be
 * zeroed by one thread while another reads it. */
static const uint8_t BYTE_TO_SEQ[256] = {
    [1] = 1, [2] = 2, [3] = 3,
    ['C'] = 1, ['c'] = 1,
    ['G'] = 2, ['g'] = 2,
    ['T'] = 3, ['t'] = 3,
    ['U'] = 3, ['u'] = 3,
};

static FxResult *fail(FxResult *r, const char *msg, const char *path) {
    size_t n = strlen(msg) + strlen(path) + 4;
    r->error = (char *)malloc(n);
    if (r->error) snprintf(r->error, n, "%s: %s", path, msg);
    return r;
}

typedef struct {
    uint8_t *codes; int64_t codes_len, codes_cap;
    int64_t *starts, *ends; int64_t n_rec, rec_cap;
    char *names; int64_t names_len, names_cap;
} Builder;

static int b_init(Builder *b, int64_t hint) {
    b->codes_cap = hint > 64 ? hint : 64;
    b->codes = (uint8_t *)malloc((size_t)b->codes_cap);
    b->rec_cap = 1024;
    b->starts = (int64_t *)malloc(sizeof(int64_t) * (size_t)b->rec_cap);
    b->ends = (int64_t *)malloc(sizeof(int64_t) * (size_t)b->rec_cap);
    b->names_cap = 1 << 16;
    b->names = (char *)malloc((size_t)b->names_cap);
    b->codes_len = b->n_rec = b->names_len = 0;
    return b->codes && b->starts && b->ends && b->names;
}

static int b_grow_rec(Builder *b) {
    if (b->n_rec < b->rec_cap) return 1;
    b->rec_cap *= 2;
    int64_t *s = (int64_t *)realloc(b->starts,
                                    sizeof(int64_t) * (size_t)b->rec_cap);
    if (!s) return 0;
    b->starts = s;
    int64_t *e = (int64_t *)realloc(b->ends,
                                    sizeof(int64_t) * (size_t)b->rec_cap);
    if (!e) return 0;
    b->ends = e;
    return 1;
}

static int b_name(Builder *b, const uint8_t *p, int64_t n, int skip) {
    if (skip) return 1;
    while (b->names_len + n + 1 > b->names_cap) {
        b->names_cap *= 2;
        char *nn = (char *)realloc(b->names, (size_t)b->names_cap);
        if (!nn) return 0;
        b->names = nn;
    }
    memcpy(b->names + b->names_len, p, (size_t)n);
    b->names_len += n;
    b->names[b->names_len++] = '\n';
    return 1;
}

/* encode [p, p+n) sequence bytes into codes (caller ensured capacity) */
static void b_seq(Builder *b, const uint8_t *p, int64_t n) {
    uint8_t *dst = b->codes + b->codes_len;
    for (int64_t i = 0; i < n; i++) dst[i] = BYTE_TO_SEQ[p[i]];
    b->codes_len += n;
}

/* line end excluding '\n' and a trailing '\r' */
static inline const uint8_t *line_end(const uint8_t *p, const uint8_t *lim,
                                      const uint8_t **next) {
    const uint8_t *nl = (const uint8_t *)memchr(p, '\n', (size_t)(lim - p));
    const uint8_t *e = nl ? nl : lim;
    *next = nl ? nl + 1 : lim;
    if (e > p && e[-1] == '\r') e--;
    return e;
}

static FxResult *parse_data(FxResult *r, uint8_t *data, int64_t len,
                            int skip_names, const char *path,
                            int own_data) {
    const uint8_t *p = data, *lim = data + len;
    while (p < lim && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
        p++;
    if (p >= lim) { if (own_data) free(data); return fail(r, "empty file", path); }

    Builder b;
    if (!b_init(&b, len)) { if (own_data) free(data); return fail(r, "oom", path); }
    int ok = 1;

    if (*p == '>') { /* FASTA: header line, then sequence lines */
        while (p < lim && ok) {
            if (*p != '>') { ok = 0; break; }
            const uint8_t *next, *he = line_end(p, lim, &next);
            if (!b_grow_rec(&b) || !b_name(&b, p + 1, he - (p + 1),
                                           skip_names)) { ok = 0; break; }
            b.starts[b.n_rec] = b.codes_len;
            p = next;
            while (p < lim && *p != '>') {
                const uint8_t *se = line_end(p, lim, &next);
                b_seq(&b, p, se - p);
                p = next;
            }
            b.ends[b.n_rec] = b.codes_len;
            b.n_rec++;
        }
        if (!ok && !r->error) {
            if (own_data) free(data);
            free(b.codes); free(b.starts); free(b.ends); free(b.names);
            return fail(r, "malformed fasta", path);
        }
    } else if (*p == '@') { /* FASTQ: strict 4-line records */
        while (p < lim && ok) {
            /* skip blank lines between records and at end-of-file */
            const uint8_t *q = p;
            int blank = 1;
            while (q < lim) {
                if (*q == '\n' || *q == '\r') q++;
                else { blank = 0; break; }
            }
            if (blank) break;
            p = q;
            if (*p != '@') { ok = 0; break; }
            const uint8_t *next, *he = line_end(p, lim, &next);
            if (!b_grow_rec(&b) || !b_name(&b, p + 1, he - (p + 1),
                                           skip_names)) { ok = 0; break; }
            p = next;
            if (p >= lim) { ok = 0; break; }
            const uint8_t *se = line_end(p, lim, &next);
            b.starts[b.n_rec] = b.codes_len;
            b_seq(&b, p, se - p);
            b.ends[b.n_rec] = b.codes_len;
            int64_t seq_len = se - p;
            b.n_rec++;
            p = next;
            if (p >= lim || *p != '+') { ok = 0; break; }
            line_end(p, lim, &next); /* '+' line */
            p = next;
            if (p >= lim) { ok = 0; break; }
            const uint8_t *qe = line_end(p, lim, &next);
            if (qe - p != seq_len) { ok = 0; break; } /* qual len check */
            p = next;
        }
        if (!ok) {
            if (own_data) free(data);
            free(b.codes); free(b.starts); free(b.ends); free(b.names);
            return fail(r, "malformed fastq", path);
        }
    } else {
        if (own_data) free(data);
        free(b.codes); free(b.starts); free(b.ends); free(b.names);
        return fail(r, "not a fasta/fastq file", path);
    }

    if (own_data) free(data);
    r->codes = b.codes;
    r->n_codes = b.codes_len;
    r->starts = b.starts;
    r->ends = b.ends;
    r->n_records = b.n_rec;
    r->names = b.names;
    r->names_len = b.names_len;
    return r;
}

/* parse an in-memory (already decompressed) fasta/fastq block — the
 * streaming-ingest entry point: the caller decodes gzip in chunks, cuts
 * at record boundaries, and parses each block while the next decodes. */
FxResult *fx_parse_buffer(const uint8_t *data, int64_t len,
                          int skip_names) {
    FxResult *r = (FxResult *)calloc(1, sizeof(FxResult));
    if (!r) return NULL;
    return parse_data(r, (uint8_t *)data, len, skip_names, "<buffer>", 0);
}

void fx_free(FxResult *r) {
    if (!r) return;
    free(r->codes);
    free(r->starts);
    free(r->ends);
    free(r->names);
    free(r->error);
    free(r);
}
