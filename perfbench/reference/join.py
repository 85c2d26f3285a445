"""The plain reference of the join: for every index k-mer, how many times
the sample holds it; per genome, how many of its k-mers the sample holds
j times (sylph src/contain.rs:624-660, as a histogram clamped at H - 1).
"""

import torch

from ..gen.hashing import INT64_MIN


def histograms(index, sketches, H: int):
    """([S, G, H] int64 histograms of S sketches, [G] int64 k-mers a
    genome, [S, chunks] int64 index k-mers each sample holds, by chunk),
    read from the index's flat view block by block. ``sketches`` are
    (keys in uint64 order, counts) pairs; bin 0 is left 0."""
    G, S = index.G, len(sketches)
    dev = sketches[0][0].device
    hist = torch.zeros((S, G * H), dtype=torch.int64, device=dev)
    n_kmers = torch.zeros(G, dtype=torch.int64, device=dev)
    matched = {}
    ordered = [(k ^ INT64_MIN, c) for k, c in sketches]
    for chunk, keys, gids in index.flat_blocks():
        gids = gids.to(torch.int64)
        n_kmers += torch.bincount(gids, minlength=G)
        bk, order = torch.sort(keys ^ INT64_MIN)
        bg = gids[order]
        edge = torch.stack([bk[0], bk[-1]])
        for s, (sk, sc) in enumerate(ordered):
            a = int(torch.searchsorted(sk, edge[:1]))
            b = int(torch.searchsorted(sk, edge[1:], right=True))
            q, qc = sk[a:b], sc[a:b]
            lo = torch.searchsorted(bk, q)
            n = torch.searchsorted(bk, q, right=True) - lo
            total = int(n.sum())
            matched[s, chunk] = matched.get((s, chunk), 0) + total
            if total == 0:
                continue
            first = torch.cumsum(n, 0) - n
            pos = (torch.repeat_interleave(lo - first, n, output_size=total)
                   + torch.arange(total, device=dev))
            cnt = torch.repeat_interleave(qc, n, output_size=total)
            hist[s] += torch.bincount(
                bg[pos] * H + torch.clamp(cnt, max=H - 1), minlength=G * H)
    per_chunk = torch.zeros((S, 1 + max(c for _, c in matched)),
                            dtype=torch.int64)
    for (s, c), n in matched.items():
        per_chunk[s, c] = n
    return hist.view(S, G, H), n_kmers, per_chunk
