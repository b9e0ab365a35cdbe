"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.ann.*``: the IVF index's upload, routing, pair inversion,
scoring, regroup, finish and fetch, outside the kernel wrappers, in the
batched cells (``portbench.spans``)."""

from portbench.spans import reader

read = reader("ann")
