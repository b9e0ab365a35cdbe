"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.api.*``: the public search entry's own work (intake, the lock,
the filter mask, the dispatch) and the result's assembly, in the single-
query cells (``portbench.spans``)."""

from portbench.spans import reader

read = reader("api")
