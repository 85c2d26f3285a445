"""sylph_tpu_torch — the PyTorch/CUDA port of sylph_tpu for NVIDIA H100s
(one card, or several cards and processes).

Layout follows the JAX package so each counterpart is easy to find:
  - gpu/     device layer: int64 key conventions, the grange engine and the
             wrappers of the hand-written CUDA kernels (csrc/*.cu) with their
             plain PyTorch versions
  - engine/  query/profile/sketch orchestration, candidate prefilter,
             device engine, device read seeding and the streamed sample
  - io/, core/, kmer/, stats/, utils/  host code copied from sylph_tpu,
             and utils/distributed.py, the process group of --coordinator
  - multichip.py  the multi-device dry run and the worker of its ranks
  - native/  trimmed copies of sylph_tpu's host C sources, built with cc
             into build/native/ at first use

The port imports torch and numpy, never jax and nothing of sylph_tpu. Its
entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
