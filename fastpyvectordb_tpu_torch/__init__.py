"""fastpyvectordb_tpu_torch — the PyTorch/CUDA port of fastpyvectordb_tpu.

The same collection API and on-disk format as the JAX package, on torch
tensors: the exact scan and the int8 / int4 two-stage quantized scans,
with hand-written Hopper kernels for the quantized scores
(``kernels/quant_kernels.py``, ``csrc/quant_scores.cu``).  Everything runs
on ``device="cuda"`` unless the caller passes ``device="cpu"``.  This
package never imports jax.
"""

from .core.types import (  # noqa: F401
    CollectionConfig,
    DistanceMetric,
    SearchResult,
)
from .core.filters import Filter, FilterOp  # noqa: F401
from .core.collection import Collection  # noqa: F401
from .core.vectordb import VectorDB  # noqa: F401
from .state import collection_from_sections  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "CollectionConfig",
    "DistanceMetric",
    "SearchResult",
    "Filter",
    "FilterOp",
    "Collection",
    "VectorDB",
    "collection_from_sections",
    "__version__",
]
