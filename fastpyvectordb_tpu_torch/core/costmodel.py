"""Serving-mode cost model for ``Collection.optimize()`` (port of
``fastpyvectordb_tpu/core/costmodel.py``), with one NVIDIA H100's rates.

Ranking serving modes by device bytes a query alone misranks
compute-bound modes (IVF-PQ's ADC does rows * M * K operations), so each
mode gets a roofline estimate:

    cost_us = max(stream_bytes / HBM_BW, flops / TENSOR_RATE)
              + gather_rows * (GATHER_ROW_LAT + row_bytes / HBM_BW)
              + serial_s

- ``HBM_BW`` and ``TENSOR_RATE``: one H100 SXM's data-sheet rates (dense,
  at its 700 W limit): 3.35 TB/s; 989 TFLOP/s bf16 and fp16, 1,979 TOP/s
  int8, 67 TFLOP/s f32 outside the tensor cores.  ``chip_smoke.py``
  computes its kernel bounds from these same constants.
- ``GATHER_ROW_LAT`` and ``SERIAL_DISPATCH``: measured by the micro-timing
  of ``chip_smoke.py``'s optimize phase (``measure_constants``) on an
  NVIDIA H100 80GB HBM3 at a 700 W power limit: the latency a randomly
  gathered row adds beyond its bytes (a B=1024 x 40-row gather from a
  1M x 768 f32 store), and the time of one data-dependent serial step
  (a gather, a product and a top-k that the next step's indices come
  from, queued on one stream).

The model's job is ordering.  On a card ``optimize()`` times every
candidate and the measured time ranks; the model decides only on the CPU,
where wall-clock says nothing about the card, and is always reported.  It
counts a mode's product and gathers, not the PyTorch passes over a (B, N)
score block (``torch.topk``, the mask fill), which set the exact modes'
pace on the card: it ranks the int8 two-stage scan below the exact bf16
scan and below a deep-re-rank IVF-PQ, as the card does, but the exact
scan below IVF-PQ, where the card measures the reverse.

Two faults of the JAX module are not carried over: the pq flops term
takes the quantizer's K (``pq_k``) instead of a literal 16, and
``ivf_cost`` picks the int8 rate by bytes per dimension (int8 cells are
D bytes a row).
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BW = 3.35e12          # bytes/s, H100 SXM data sheet
TENSOR_RATE = {           # dense operations/s, H100 SXM data sheet
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
    "float32": 67e12,     # outside the tensor cores (TF32 is off)
}
# measured by chip_smoke.py measure_constants on an NVIDIA H100 80GB HBM3
# at a 700 W power limit (B=1024 x 40 rows of 3,072 B gathered in 0.0893
# ms; one serial step 104.5 us, set by the host's launches)
GATHER_ROW_LAT = 1.26e-9  # s/row beyond the row's bytes
SERIAL_DISPATCH = 104.5e-6  # s, per data-dependent serial step


@dataclass
class ModeCost:
    """Per-query roofline estimate for one serving mode."""
    stream_bytes: float     # device bytes streamed per query (batch-amortized)
    flops: float            # operations per query
    rate: float             # operations/s of the mode's compute type
    gather_rows: float = 0.0
    row_bytes: float = 0.0
    serial_s: float = 0.0

    @property
    def cost_us(self) -> float:
        roof = max(self.stream_bytes / HBM_BW, self.flops / self.rate)
        gather = self.gather_rows * (GATHER_ROW_LAT
                                     + self.row_bytes / HBM_BW)
        return 1e6 * (roof + gather + self.serial_s)


def exact_cost(n: int, d: int, store_bytes: int, compute_dtype: str,
               batch: int) -> ModeCost:
    """Distance GEMM scan: corpus streamed once per batch, n*d MACs/query."""
    return ModeCost(stream_bytes=n * d * store_bytes / batch,
                    flops=2.0 * n * d,
                    rate=TENSOR_RATE.get(compute_dtype,
                                         TENSOR_RATE["float32"]))


def quantized_cost(n: int, d: int, kind: str, code_bytes: float,
                   store_bytes: int, rerank_rows: int,
                   batch: int, pq_k: int = 16) -> ModeCost:
    """Two-stage compressed scan + exact re-rank of ``rerank_rows``.

    int8 / int4 run an s8 x s8 -> s32 product; binary a +-1 int8 product
    of the same size; pq M*K operations a row for the table sum
    (``code_bytes`` == M, ``pq_k`` the quantizer's K)."""
    if kind in ("int8", "int4", "binary"):
        rate, flops = TENSOR_RATE["int8"], 2.0 * n * d
    elif kind == "pq":
        rate, flops = TENSOR_RATE["bfloat16"], 2.0 * n * code_bytes * pq_k
    else:
        rate, flops = TENSOR_RATE["bfloat16"], 2.0 * n * d
    return ModeCost(stream_bytes=n * code_bytes / batch, flops=flops,
                    rate=rate, gather_rows=float(rerank_rows),
                    row_bytes=d * store_bytes)


def ivf_cost(n: int, d: int, cell_bytes: float, nlist: int, nprobe: int,
             overflow: int, store_bytes: int, rerank_rows: int,
             batch: int, slack: float = 1.25,
             pq_k: int = 0) -> ModeCost:
    """Grouped (cell-major) IVF / IVF-PQ: the probed fraction of cells
    streams once per batch.  ``cell_bytes`` is the bytes of one cell row
    (D for int8 cells, 2D / 4D for bf16 / f32, M for IVF-PQ codes);
    ``pq_k`` > 0 switches to IVF-PQ's table-sum flops term.  Routing adds
    a B x nlist product.  At large batch most cells are touched by some
    query, so the stream term uses min(nprobe/nlist * batch, 1)
    coverage."""
    frac = min(1.0, nprobe / max(nlist, 1))
    rows = frac * n * slack + overflow
    coverage = min(1.0, frac * batch)     # distinct-cell fraction per batch
    stream = (coverage * n * slack + overflow) * cell_bytes / batch
    if pq_k > 0:
        flops = 2.0 * rows * cell_bytes * pq_k + 2.0 * nlist * d
        rate = TENSOR_RATE["bfloat16"]
    else:
        flops = 2.0 * rows * d + 2.0 * nlist * d
        # bytes per dimension: int8 cells run the s8 product
        rate = TENSOR_RATE["int8"] if cell_bytes <= 1.01 * d else \
            TENSOR_RATE["bfloat16"]
    return ModeCost(stream_bytes=stream, flops=flops, rate=rate,
                    gather_rows=float(rerank_rows),
                    row_bytes=d * store_bytes)


def graph_cost(d: int, store_bytes: int, beam: int, iters: int,
               expand: int, degree: int) -> ModeCost:
    """Serial beam search (ann/graph_ann.py, the cost of the graph kind in
    ``Collection.optimize``): ``iters`` data-dependent rounds, the serial
    chain modeled as one ``SERIAL_DISPATCH`` a round.  The formula is the
    JAX package's and counts ``beam*expand*degree`` gathered rows a round;
    the search gathers ``expand*degree`` a round (the neighbour lists of
    the E entries it expands), so the term over-counts by ``beam``
    (a reference-side defect, kept so the two packages agree)."""
    rows = float(iters) * beam * expand * degree
    return ModeCost(stream_bytes=0.0, flops=2.0 * rows * d,
                    rate=TENSOR_RATE["bfloat16"], gather_rows=rows,
                    row_bytes=d * store_bytes,
                    serial_s=iters * SERIAL_DISPATCH)
