"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.ann.*``: the graph index's query upload, routing, beam rounds,
finish and fetch, in the single-query graph cell (``portbench.spans``).
Nothing where the trace holds no ``fpv.ann.*`` range (a program whose graph
search records none)."""

from portbench.spans import idle_ms_per_call


def read(ctx):
    if not any(e.get("name", "").startswith("fpv.ann.")
               for e in ctx.trace.host):
        return None
    return idle_ms_per_call(ctx, "ann")
