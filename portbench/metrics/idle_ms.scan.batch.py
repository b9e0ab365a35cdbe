"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.scan.*``: the two-stage scan's upload, coarse stage, re-rank
and fetch, outside the kernel wrappers, in the batched cells
(``portbench.spans``)."""

from portbench.spans import reader

read = reader("scan")
