"""VectorDB: a directory of named collections (port of
``fastpyvectordb_tpu/core/vectordb.py``).

Every collection lives on the database's torch device: ``"cuda"`` unless
the caller passes ``device="cpu"``.  Directories written by the JAX package
load here and the other way round.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional

from ..utils import resolve_device
from .collection import STORE_FILE, Collection
from .types import CollectionConfig, DistanceMetric


class VectorDB:
    def __init__(self, path: Optional[str] = "./vectordb_data", device=None):
        self.device = resolve_device(device)
        self.path = Path(path) if path is not None else None
        self._collections: Dict[str, Collection] = {}
        self._lock = threading.RLock()
        if self.path is not None and self.path.exists():
            self._load_collections()

    def _load_collections(self) -> None:
        for sub in sorted(self.path.iterdir()):
            if not sub.is_dir():
                continue
            cfg = Collection.load_config_sidecar(sub)
            has_wal = (sub / "wal.log").exists()
            if not ((sub / STORE_FILE).exists()
                    or (cfg is not None and has_wal)):
                continue
            if cfg is None:  # pre-sidecar directory: config loads from FPVT
                cfg = CollectionConfig(name=sub.name, dimensions=1)
            col = Collection(cfg, base_path=sub, device=self.device)
            self._collections[col.config.name] = col

    def create_collection(self, name: str, dimensions: int,
                          metric: "DistanceMetric | str" = DistanceMetric.COSINE,
                          **config_kwargs) -> Collection:
        with self._lock:
            if name in self._collections:
                raise ValueError(f"collection {name!r} already exists")
            cfg = CollectionConfig(name=name, dimensions=dimensions,
                                   metric=DistanceMetric.parse(metric),
                                   **config_kwargs)
            base = self.path / name if self.path is not None else None
            col = Collection(cfg, base_path=base, device=self.device)
            self._collections[name] = col
            return col

    def get_collection(self, name: str) -> Collection:
        with self._lock:
            if name not in self._collections:
                raise KeyError(f"collection {name!r} does not exist")
            return self._collections[name]

    def get_or_create_collection(self, name: str, dimensions: int,
                                 **kwargs) -> Collection:
        with self._lock:
            if name in self._collections:
                return self._collections[name]
            return self.create_collection(name, dimensions, **kwargs)

    def delete_collection(self, name: str) -> bool:
        with self._lock:
            col = self._collections.pop(name, None)
            if col is None:
                return False
            if col.base_path is not None and col.base_path.exists():
                shutil.rmtree(col.base_path)
            return True

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._collections.keys())

    def save(self) -> None:
        with self._lock:
            for col in self._collections.values():
                if col.base_path is not None:
                    col.save()

    def __getitem__(self, name: str) -> Collection:
        return self.get_collection(name)

    def __contains__(self, name: str) -> bool:
        return name in self._collections
