"""A sample's result as it reaches the host: the port's per-genome
statistics (``GenomeStats``) and the join's probe, packed on the device
into one int32 tensor so that one copy brings them back. The copy is
queued right behind the sample's own work (``Fetch``), so the client
waits for its sample and not for the one dispatched after it."""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .reference.stats import FLOATS

INTS = ("contained", "n_inliers", "lam_valid", "valid")


@dataclass
class Result:
    stats: dict                            # field -> host array [G]
    hist: Optional[torch.Tensor] = None    # [G, H], kept runs only
    stream: Optional[torch.Tensor] = None  # seeding output, kept runs only
    retried: bool = False                  # the probe failed: swept again
    fallback: bool = False                 # and again: the per-chunk path


def pack(st, probe: torch.Tensor) -> torch.Tensor:
    """[6G + 4G + 4] int32: the float fields' bits, the integer fields, the
    probe's two int64."""
    floats = torch.stack([getattr(st, f).to(torch.float32) for f in FLOATS])
    ints = torch.stack([getattr(st, f).to(torch.int32) for f in INTS])
    return torch.cat([floats.view(torch.int32).reshape(-1), ints.reshape(-1),
                      probe.to(torch.int64).reshape(2).view(torch.int32)])


def unpack(host: np.ndarray, G: int):
    """(stats {field: [G] array}, probe [2] int64) of a fetched pack."""
    nf = len(FLOATS)
    floats = host[:nf * G].view(np.float32).reshape(nf, G)
    ints = host[nf * G:(nf + len(INTS)) * G].reshape(len(INTS), G)
    stats = {f: floats[i] for i, f in enumerate(FLOATS)}
    stats.update({f: ints[i] for i, f in enumerate(INTS)})
    return stats, host[(nf + len(INTS)) * G:].view(np.int64)


class Fetch:
    """A device tensor's copy to the host, queued now on the current
    stream into a pinned buffer; ``get()`` waits for it and returns the
    result in pageable memory, giving the buffer back for the next fetch of
    that shape. So only the warm-up allocates page-locked memory: one
    ``cudaHostAlloc`` a sample inside the window, as a buffer held by each
    result would need, stalled the host for up to tens of ms."""

    _free: dict = {}        # (shape, dtype) -> pinned buffers not in use

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            free = Fetch._free.setdefault((tuple(t.shape), t.dtype), [])
            self.host = free.pop() if free else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.out = None
        else:
            self.out = t.cpu().numpy()

    def get(self) -> np.ndarray:
        if self.out is None:
            self.event.synchronize()
            self.out = self.host.numpy().copy()
            Fetch._free[(tuple(self.host.shape), self.host.dtype)].append(
                self.host)
            self.host = None
        return self.out
