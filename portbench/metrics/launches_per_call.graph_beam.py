"""Kernel launches a traced call made from inside the graph search's beam
rounds: host launch events (``cuda_runtime`` ``cudaLaunchKernel*`` or
``cuda_driver`` ``cuLaunchKernel*``) that start inside an ``fpv.ann.beam``
range, on the thread that ran the calls (the one that holds the most
``fpv.*`` time), counted once per correlation id, over the calls traced.
What a fused or captured beam would cut.  Nothing where the trace holds no
``fpv.ann.beam`` range (a program whose graph search records none)."""

import bisect

BEAM = "fpv.ann.beam"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(ctx):
    trace = ctx.trace
    fpv, beams = {}, []
    for e in trace.host:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("fpv."):
            thread = (e.get("pid"), e.get("tid"))
            fpv[thread] = fpv.get(thread, 0.0) + float(e["dur"])
            if name == BEAM:
                beams.append((thread, float(e["ts"]),
                              float(e["ts"]) + float(e["dur"])))
    if not beams or not trace.calls:
        return None
    calls = max(fpv, key=fpv.get)
    spans = sorted((s, t) for thread, s, t in beams if thread == calls)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    seen = set()
    for e in trace.host:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or \
                not e.get("name", "").startswith(LAUNCHES) or \
                (e.get("pid"), e.get("tid")) != calls:
            continue
        ts = float(e["ts"])
        at = bisect.bisect_right(starts, ts) - 1
        if at >= 0 and ts < spans[at][1]:
            seen.add(e.get("args", {}).get("correlation", id(e)))
    return len(seen) / trace.calls
