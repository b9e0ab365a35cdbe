"""Small shared utilities with no better home (``next_pow2`` copied from
``fastpyvectordb_tpu/utils.py``)."""

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n <= 1 -> 1).  The single shared
    implementation behind store capacity buckets, IVF chunk sizing, and
    quantized-scan chunking."""
    p = 1
    while p < n:
        p <<= 1
    return p


def resolve_device(device=None):
    """The torch device a collection lives on.  ``None`` means ``"cuda"``:
    the CPU is used only when the caller names it, and a CUDA device on a
    host without one raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
