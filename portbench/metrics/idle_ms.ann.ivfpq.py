"""Milliseconds a traced call in which the card ran nothing while the host was
inside ``fpv.ann.*``: the IVF-PQ index's upload, routing, pair inversion,
tables, scoring, regroup, overflow block, finish and fetch, outside the
kernel wrappers, in the 10M IVF-PQ cell (``portbench.spans``).  Nothing
where the trace holds no ``fpv.ann.*`` range (a program whose IVF-PQ path
records none)."""

from portbench.spans import idle_ms_per_call


def read(ctx):
    if not any(e.get("name", "").startswith("fpv.ann.")
               for e in ctx.trace.host):
        return None
    return idle_ms_per_call(ctx, "ann")
