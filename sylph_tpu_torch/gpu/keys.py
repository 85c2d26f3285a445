"""int64 key conventions of the port (replace sylph_tpu/tpu/u64.py's
(hi, lo) uint32 pairs).

- A 64-bit hash is one int64 bit pattern, compared in uint64 order. At
  c = 1 a real hash can be 2^63 or more, negative as an int64, so a sort
  or search of keys runs on ``u64_order(keys)`` (the bits xor INT64_MIN,
  whose int64 order is the uint64 order of the keys) and flips back.
- The uint32 pad pair (SENT, SENT) becomes KEY_PAD = -1: the same 64 bits,
  u64::MAX. A hash is kept only below u64::MAX / c, so no kept hash equals
  it, and the pad sorts after every real key in uint64 order.
- Codes are int32 with SENT = -1, the same bits as 0xFFFFFFFF. Code space
  is g_eff * 64 < 2^31, so every real code is non-negative.
- ``>>`` on int64 is arithmetic, so the high word is masked: the pad's
  high word is 0xFFFFFFFF, which keeps it at or past every real high word
  (at c = 1 a real hash can share it) just as the uint32 sentinel was.
"""

import numpy as np
import torch

KEY_PAD = -1                  # (SENT, SENT) as one int64
SENT = -1                     # int32 code sentinel (0xFFFFFFFF)
HIST_H = 64                   # multiplicity clamp for histograms
_M32 = 0xFFFFFFFF
_INT64_MIN = -(1 << 63)


def key_hi(keys: torch.Tensor) -> torch.Tensor:
    """High 32 bits (as a non-negative int64) of int64 keys."""
    return (keys >> 32) & _M32


def u64_order(keys: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """int64 keys whose int64 order is the uint64 order of ``keys`` (the
    bits xor INT64_MIN); applied twice it gives the keys back."""
    return keys.bitwise_xor_(_INT64_MIN) if inplace else keys ^ _INT64_MIN


def from_pair_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """uint32 (hi, lo) pair arrays -> int64 keys; (SENT, SENT) -> -1."""
    u = ((np.asarray(hi, np.uint64) << np.uint64(32))
         | np.asarray(lo, np.uint64))
    return u.view(np.int64)
