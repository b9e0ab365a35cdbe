"""State carried across from the JAX package.

A collection's state is plain numpy arrays, lists and JSON meta: the
``vectors`` / ``valid`` arrays of ``DeviceVectorStore.export_arrays()``, the
``ann_*`` sections of ``IVFIndex`` / ``IVFPQIndex`` /
``GraphANN.export_sections()``, the ``quant_*`` sections of
``QuantizedScan.export_sections()``, and the ``ids`` / ``metadata`` /
``config`` sections a collection saves.  Both packages write exactly that
into their FPVT containers, so one function turns it into a port
``Collection`` — for a file on disk (``Collection._load``) and for state
handed over in memory (``collection_from_sections``).
"""

from __future__ import annotations

import numpy as np

from .ann import KINDS as ANN_KINDS
from .core.collection import Collection
from .core.store import DeviceVectorStore
from .core.types import CollectionConfig


def restore_into(col: Collection, meta: dict, sections: dict) -> None:
    """Replace ``col``'s rows, ids, metadata, ANN index and quantized
    snapshot with the given state, on ``col.device``.  An ``"ivf"`` index
    (centroids, row table, overflow rows, nprobe, rerank, int8
    ``vmin``/``scale``) is carried across through ``IVFIndex.from_sections``,
    an ``"ivfpq"`` one (centroids, codebooks, PQ codes and reconstruction
    norms, row table, overflow rows, nprobe, rerank) through
    ``IVFPQIndex.from_sections``, a ``"graph"`` one (neighbour table,
    routing centroids and medoids, beam / expand / iters / n_init) through
    ``GraphANN.from_sections``.  Quantized snapshots of every kind (int8 /
    int4 ``vmin``/``scale``, binary thresholds, pq codebooks) come across
    through ``QuantizedScan.from_sections``."""
    ann_meta = meta.get("ann")
    if ann_meta and ann_meta.get("kind") not in ANN_KINDS:
        # dropping the section would change what search() serves
        raise ValueError(
            f"unknown ANN index kind {ann_meta.get('kind')!r} in the file")
    cfg = CollectionConfig.from_dict(meta["config"])
    col.config = cfg
    valid = np.asarray(sections["valid"], dtype=bool)
    col._store = DeviceVectorStore.from_arrays(
        np.asarray(sections["vectors"], dtype=np.float32), valid,
        storage_dtype=cfg.storage_dtype, device=col.device)
    col._row_to_id = list(sections["ids"])
    col._metadata = list(sections["metadata"])
    col._id_to_row = {i: r for r, i in enumerate(col._row_to_id)
                      if i is not None and valid[r]}
    col._row_epoch += 1  # row space replaced wholesale
    col._bump()
    col._serving_mode = meta.get("serving_mode")
    col._ann = None
    if ann_meta:
        index_cls, _ = ANN_KINDS[ann_meta["kind"]]
        col._ann = index_cls.from_sections(
            col, {k: v for k, v in sections.items() if k.startswith("ann_")},
            ann_meta)
    q_meta = meta.get("quantized")
    if q_meta:
        from .quant.scan import QuantizedScan
        col._quantized = QuantizedScan.from_sections(
            col, {k: v for k, v in sections.items()
                  if k.startswith("quant_")}, q_meta)


def collection_from_sections(meta: dict, sections: dict,
                             device=None) -> Collection:
    """A port ``Collection`` (no base path) from exported state.
    ``device`` defaults to ``"cuda"`` like every port constructor."""
    col = Collection(CollectionConfig.from_dict(meta["config"]),
                     device=device)
    restore_into(col, meta, sections)
    return col
