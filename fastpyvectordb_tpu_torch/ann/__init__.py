"""ann layer of the PyTorch port."""

from .graph_ann import GraphANN
from .ivf import IVFIndex
from .ivfpq import IVFPQIndex

# each ANN kind a collection builds: its index class, and its recall knobs
# (an explicit one turns the build-time auto-tune off)
KINDS = {"ivf": (IVFIndex, ("nprobe",)),
         "ivfpq": (IVFPQIndex, ("nprobe", "rerank")),
         "graph": (GraphANN, ("beam", "iters"))}
