"""Fixtures of the file-to-TSV bench configs, written once under
.bench_data/ (counterpart of scripts/gen_e2e_fixture.py and
scripts/gen_gtdb_cli_fixture.py: the same files, byte for byte, from the
same seeds, so either package's bench reads either's fixtures).

    python -m sylph_tpu_torch.bench_fixtures e2e [--paired] [--device cuda|cpu]
    python -m sylph_tpu_torch.bench_fixtures gtdb_cli [--genomes N]
        [--device cuda|cpu]

e2e (.bench_data/e2e/):
  - genomes/g0000.fa .. g0063.fa: 64 synthetic 1-Mbp genomes
  - db.syldb: their ``sketch -g`` (c=200, k=31) by this package, seeded on
    ``--device``
  - reads.fastq.gz: ~1.07 Gbp of 150-bp reads, 80% from 8 of the genomes
    at staggered coverage and 20% random, BGZF (level 1)
  - with --paired, reads_R1/R2.fastq.gz: ~0.54 Gbp each, 300-bp fragments
    of the same 8 genomes (R1 the head, R2 the tail)

gtdb_cli (.bench_data/gtdb_cli/):
  - db.syldb: 100,000 synthetic genome sketches of 7,168 k-mers (~5.8 GB),
    the hash population of the bench's host-built GTDB index
  - reads.fastq.gz: ~1.07 Gbp of 150-bp reads; 64 abundant genomes carry
    their usable k-mers (20% of them twice: adjusted ANI about 95.9% at
    12.5% containment, the low-coverage correction's regime), the other
    reads singleton plants of the other genomes (~1% containment noise)

The gtdb_cli database groups k-mers by genome with a stable sort of the
genome ids on ``--device`` (the JAX generator's radix sort gives the same
order). Both default to the card and raise without one unless asked for the
CPU.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from .bench import DATA, _rc31_np, _synth_sorted_index

E2E_GENOMES = 64
E2E_GLEN = 1_000_000
READ_LEN = 150
TOTAL_BP = 1_073_741_824            # ~1.07 Gbp
KPG = 7168
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CHUNK = 65536
_SHARES = (28, 17, 11, 8, 6, 5, 3, 2)


def _fastq_chunk(seqs, prefix: bytes, rid0: int, tmpl_mid: bytes,
                 suffix: bytes = b"") -> bytes:
    parts = []
    for i in range(seqs.shape[0]):
        parts.append(b"@" + prefix + b"%d" % (rid0 + i) + suffix + b"\n")
        parts.append(seqs[i].tobytes())
        parts.append(tmpl_mid)
    return b"".join(parts)


def _write_bgzf(path, chunks):
    from .io import bgzf
    bgzf.write(path, chunks, level=1)


def gen_e2e(out: str, paired: bool = False, device="cuda",
            log=lambda *_: None) -> None:
    """Write the e2e fixture under ``out`` (files already there are kept,
    as the JAX generator keeps them)."""
    from .engine.sketch_cmd import SketchOptions, sketch
    n_genomes, glen, total_bp = E2E_GENOMES, E2E_GLEN, TOTAL_BP
    os.makedirs(os.path.join(out, "genomes"), exist_ok=True)
    rng = np.random.default_rng(42)
    genomes, paths = [], []
    for g in range(n_genomes):
        codes = rng.integers(0, 4, size=glen, dtype=np.uint8)
        genomes.append(codes)
        p = os.path.join(out, "genomes", f"g{g:04d}.fa")
        if not os.path.exists(p):
            with open(p, "wb") as f:
                f.write(b">genome%04d synthetic\n" % g)
                f.write(BASES[codes].tobytes())
                f.write(b"\n")
        paths.append(p)
    log("genomes written")
    db = os.path.join(out, "db")
    if not os.path.exists(db + ".syldb"):
        sketch(SketchOptions(files=[], genomes=paths, db_out_name=db,
                             threads=8, device=device))
    log("db.syldb done")

    rf = os.path.join(out, "reads.fastq.gz")
    if os.path.exists(rf):
        log("reads.fastq.gz exists")
        if paired:
            _gen_paired(out, genomes, glen, total_bp, log)
        return
    n_reads = total_bp // READ_LEN
    shares = np.array(_SHARES, np.float64)
    shares = shares / shares.sum() * 0.8
    src_counts = (shares * n_reads).astype(np.int64)
    n_noise = n_reads - int(src_counts.sum())
    tmpl_mid = b"\n+\n" + b"I" * READ_LEN + b"\n"

    def text_chunks():
        rid = 0
        for src, cnt in enumerate(src_counts.tolist()):
            codes = genomes[src]
            done = 0
            while done < cnt:
                b = min(_CHUNK, cnt - done)
                starts = rng.integers(0, glen - READ_LEN, size=b)
                idx = starts[:, None] + np.arange(READ_LEN)[None, :]
                yield _fastq_chunk(BASES[codes[idx]], b"r", rid, tmpl_mid)
                rid += b
                done += b
        done = 0
        while done < n_noise:
            b = min(_CHUNK, n_noise - done)
            seqs = BASES[rng.integers(0, 4, size=(b, READ_LEN),
                                      dtype=np.uint8)]
            yield _fastq_chunk(seqs, b"n", rid, tmpl_mid)
            rid += b
            done += b

    _write_bgzf(rf, text_chunks())
    log(f"reads.fastq.gz: {os.path.getsize(rf)} bytes")
    if paired:
        _gen_paired(out, genomes, glen, total_bp, log)


def _gen_paired(out, genomes, glen, total_bp, log):
    """reads_R1/R2.fastq.gz: fragments of 300 bp from the 8 source
    genomes, R1 the fragment's head, R2 its tail; then random pairs."""
    r1 = os.path.join(out, "reads_R1.fastq.gz")
    r2 = os.path.join(out, "reads_R2.fastq.gz")
    if os.path.exists(r1) and os.path.exists(r2):
        log("paired fixture exists")
        return
    n_pairs = total_bp // (2 * READ_LEN)
    shares = np.array(_SHARES, np.float64)
    shares = shares / shares.sum() * 0.8
    src_counts = (shares * n_pairs).astype(np.int64)
    n_noise = n_pairs - int(src_counts.sum())
    tmpl_mid = b"\n+\n" + b"I" * READ_LEN + b"\n"
    FRAG = 300

    def chunks(mate):
        rid = 0
        for src, cnt in enumerate(src_counts.tolist()):
            codes = genomes[src]
            g = np.random.default_rng(1000 + src)   # same frags per mate
            done = 0
            while done < cnt:
                b = min(_CHUNK, cnt - done)
                fs = g.integers(0, glen - FRAG, size=b)
                starts = fs if mate == 1 else fs + FRAG - READ_LEN
                idx = starts[:, None] + np.arange(READ_LEN)[None, :]
                yield _fastq_chunk(BASES[codes[idx]], b"p", rid, tmpl_mid,
                                   b"/%d" % mate)
                rid += b
                done += b
        g = np.random.default_rng(2000 + mate)
        done = 0
        while done < n_noise:
            b = min(_CHUNK, n_noise - done)
            seqs = BASES[g.integers(0, 4, size=(b, READ_LEN),
                                    dtype=np.uint8)]
            yield _fastq_chunk(seqs, b"q", rid, tmpl_mid, b"/%d" % mate)
            rid += b
            done += b

    for mate, path in ((1, r1), (2, r2)):
        _write_bgzf(path, chunks(mate))
        log(f"{path}: {os.path.getsize(path)} bytes")


def usable_mask(kmers_u64: np.ndarray) -> np.ndarray:
    """True where the hash inverts to a canonical 31-mer."""
    from .kmer.hashing import inv_mm_hash64_np
    v = inv_mm_hash64_np(kmers_u64)
    return (v < np.uint64(1) << np.uint64(62)) & (v <= _rc31_np(v))


def synth_syldb(path: str, G: int, kpg: int = KPG, c: int = 200,
                seed: int = 1, device="cuda", log=lambda *_: None):
    """Write a synthetic .syldb: G genomes x kpg k-mers from the bench
    index's hash population, grouped by genome (a stable sort of the ids
    on ``device``). Returns (kmers, gids) in sorted-hash order."""
    from .core.types import GenomeSketch
    from .gpu.grange import resolve_device
    from .io.sylformat import write_syldb

    dev = resolve_device(device)
    kmers, gids = _synth_sorted_index(G * kpg, G, c, seed=seed)
    log("index synthesized")
    pos = torch.sort(torch.from_numpy(gids).to(dev), stable=True).indices
    by_gid = kmers[pos.cpu().numpy()]
    del pos
    counts = np.bincount(gids, minlength=G)
    offs = np.concatenate([[0], np.cumsum(counts)])
    log("grouped by genome")
    sketches = [GenomeSketch(
        genome_kmers=np.ascontiguousarray(by_gid[offs[g]:offs[g + 1]]),
        # empty (not None): None marks a --disable-profiling database
        pseudotax_tracked_nonused_kmers=np.empty(0, np.uint64),
        file_name=f"synthetic/g{g:06d}.fa",
        first_contig_name=f"synthetic_contig_{g:06d}",
        c=c, k=31, gn_size=kpg * c, min_spacing=30) for g in range(G)]
    log("sketch objects built")
    write_syldb(path, sketches)
    log("syldb written")
    return kmers, gids


def plant_codes(plants_u64: np.ndarray) -> np.ndarray:
    """[n, 31] uint8 base codes of index hashes (each must be usable)."""
    from .kmer.hashing import inv_mm_hash64_np
    v = inv_mm_hash64_np(plants_u64)
    sh = (2 * (30 - np.arange(31, dtype=np.uint64)))[None, :]
    return ((v[:, None] >> sh) & np.uint64(3)).astype(np.uint8)


def synth_planted_fastq(path: str, kmers: np.ndarray, gids: np.ndarray,
                        G: int, total_bp: int = TOTAL_BP,
                        read_len: int = READ_LEN, n_abundant: int = 64,
                        seed: int = 9, log=lambda *_: None) -> int:
    """The planted read set (module docstring). Returns the read count."""
    rng = np.random.default_rng(seed)
    n_reads = total_bp // read_len
    ab_cand = kmers[gids < n_abundant]      # subset before the inversion
    ab = ab_cand[usable_mask(ab_cand)]
    # multiplicities: every plant once, 20% twice
    extra = ab[rng.random(ab.size) < 0.20]
    ab_plants = np.concatenate([ab, extra])
    log(f"abundant plants: {ab.size} unique over {n_abundant} genomes, "
        f"{ab_plants.size} occurrences")
    n_bg = n_reads - ab_plants.size
    stride = max(1, kmers.size // int(n_bg * 8.6))
    cand = kmers[::stride]
    cand_g = gids[::stride]
    # background singletons come from the other genomes only
    cand = cand[cand_g >= n_abundant]
    bg = cand[usable_mask(cand)]
    if bg.size < n_bg:
        bg = np.tile(bg, -(-n_bg // max(1, bg.size)))
    plants = np.concatenate([ab_plants, bg[:n_bg]])
    rng.shuffle(plants)
    log(f"total plants: {plants.size} ({n_reads} reads)")
    tmpl_mid = b"\n+\n" + b"I" * read_len + b"\n"

    def text_chunks():
        rid = 0
        for s in range(0, n_reads, _CHUNK):
            b = min(_CHUNK, n_reads - s)
            codes = rng.integers(0, 4, size=(b, read_len), dtype=np.uint8)
            pc = plant_codes(plants[s:s + b])
            off = rng.integers(0, read_len - 31 + 1, size=b)
            cols = off[:, None] + np.arange(31)[None, :]
            np.put_along_axis(codes, cols, pc, axis=1)
            yield _fastq_chunk(BASES[codes], b"r", rid, tmpl_mid)
            rid += b
            if (s // _CHUNK) % 16 == 0:
                log(f"reads {rid}/{n_reads}")

    _write_bgzf(path, text_chunks())
    log("fastq written")
    return n_reads


def gen_gtdb_cli(out: str, G: int = 100_000, device="cuda",
                 log=lambda *_: None) -> None:
    """Write the gtdb_cli fixture under ``out`` unless both files exist."""
    os.makedirs(out, exist_ok=True)
    db = os.path.join(out, "db.syldb")
    rf = os.path.join(out, "reads.fastq.gz")
    if os.path.exists(db) and os.path.exists(rf):
        log("fixture exists")
        return
    kmers, gids = synth_syldb(db, G, KPG, device=device, log=log)
    synth_planted_fastq(rf, kmers, gids, G, total_bp=TOTAL_BP, log=log)
    log(f"done: {os.path.getsize(db)} bytes syldb, {os.path.getsize(rf)} "
        "bytes fastq.gz")


def main(argv=None) -> int:
    if argv is None:
        from .cli import _tune_allocator
        _tune_allocator("sylph_tpu_torch.bench_fixtures")
    ap = argparse.ArgumentParser(
        prog="python -m sylph_tpu_torch.bench_fixtures",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("fixture", choices=("e2e", "gtdb_cli"))
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--genomes", type=int, default=100_000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="directory (default .bench_data/<fixture>)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    from .gpu.grange import resolve_device
    dev = resolve_device(a.device)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[{time.perf_counter() - t0:.0f}s] {msg}", flush=True)

    out = a.out or os.path.join(DATA, a.fixture)
    if a.fixture == "e2e":
        gen_e2e(out, paired=a.paired, device=dev, log=log)
    else:
        gen_gtdb_cli(out, G=a.genomes, device=dev, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
