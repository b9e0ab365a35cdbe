"""One run of one cell.

    prepare  the configuration's vectors made on the device from the seed,
             a host copy kept as the reference's input, a collection filled
             through ``insert_batch`` and its index built, the store's
             capacity and the index's own report held to what the file
             states (set-up)
    measure  the traffic's warm-up calls (set-up), the measured window of
             closed-loop calls, with ``trace`` a profiled stretch in its
             middle, the per-layer readers, the evaluation set
    close    the program's state freed
    judge    a sample of the window's answers drawn from the seed, and the
             evaluation set's, held to the plain reference
"""

from __future__ import annotations

import functools
import gc
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import checks, data, reference, spec, tracing

FOREIGN = frozenset({"jax", "jaxlib", "flax", "fastpyvectordb_tpu"})


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (names compared whole)."""
    return sorted({name.split(".")[0] for name, mod in list(sys.modules.items())
                   if mod is not None} & FOREIGN)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> Optional[int]:
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated())


class System:
    """The program under test, and the benchmark's own copy of its inputs."""

    def __init__(self, config: dict, seed: int, device):
        self.config = config = spec.checked_config(config)
        self.seed = seed
        self.device = device
        self.phases: Dict[str, float] = {}   # set-up seconds by step
        self.partition: Optional[dict] = None  # kept at close (IVF)
        t = time.perf_counter()
        rows, dims = int(config["rows"]), int(config["dims"])
        corpus, self.centers = data.clustered(config["data"], rows, dims,
                                              seed, device)
        self.corpus = corpus.cpu().numpy()
        del corpus
        t = self._phase("data", t)
        from fastpyvectordb_tpu_torch import VectorDB
        t = self._phase("import", t)
        self.db = VectorDB(None, device=device)
        self.collection = self.db.create_collection(
            "portbench", dims, **config["collection"])
        self.names = data.ids(rows)
        fill = int(config["fill"]["batch"])
        for s in range(0, rows, fill):
            self.collection.insert_batch(self.corpus[s:s + fill],
                                         self.names[s:s + fill].tolist())
        t = self._phase("fill", t)
        build = config["index"]["build"]
        getattr(self.collection, build["method"])(
            *build.get("args", []), **build.get("kwargs", {}))
        _sync(device)
        self._phase("index", t)
        self.report = self.stated()

    def stated(self) -> dict:
        """The store's capacity (``stats()``) and, where the file lists
        ``index.expect``, the index's own report (its ``stats()``, read as
        the program's server reads it) held to the file; a run whose
        system is not the one stated stops here.  Returns the report."""
        got = {"capacity_rows": self.collection.stats()["capacity"]}
        want = {"capacity_rows": self.config["fill"]["capacity_rows"]}
        expect = self.config["index"].get("expect")
        if expect:
            report = self.collection._ann.stats()
            got.update({key: report.get(key) for key in expect})
            want.update(expect)
            got["overflow_rows"] = report.get("overflow_rows")
        wrong = {key: (got[key], v) for key, v in want.items()
                 if got[key] != v}
        if wrong:
            raise RuntimeError("the built system is not the one the "
                               "configuration states (built, stated): "
                               f"{wrong}")
        return got

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - since
        return now

    def entry(self, k: int):
        """The timed call: the configuration's search method."""
        search = self.config["index"]["search"]
        return functools.partial(getattr(self.collection, search["method"]),
                                 k=k, **search.get("kwargs", {}))

    def saved_partition(self) -> Optional[dict]:
        """The IVF index's centroids, row table, overflow rows and nprobe
        from its ``export_sections()`` (None without an IVF index)."""
        index = getattr(self.collection, "_ann", None)
        if index is None:
            return None
        sections, meta = index.export_sections()
        if "ann_row_table" not in sections:
            return None
        return {"centroids": sections["ann_centroids"],
                "row_table": sections["ann_row_table"],
                "overflow_rows": sections["ann_overflow_rows"],
                "nprobe": int(meta["nprobe"])}

    def queries(self, n: int, stream: int) -> np.ndarray:
        return data.queries(self.config["data"], self.centers, n, self.seed,
                            stream)

    def close(self) -> None:
        """Free the program's state (the reference runs after it), keeping
        an IVF index's partition as the index saves it."""
        self.partition = self.saved_partition()
        self.collection = self.db = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class Measurement:
    """What one traffic mix's window left: answers, latencies, readings."""

    def __init__(self):
        self.answers: list = []       # (ids, scores, rows) a call
        self.traced: list = []        # the traced calls' answers
        self.latency_s: List[float] = []
        self.traced_at: List[int] = []  # the traced calls' places in it
        self.window_s = 0.0
        self.setup_s = 0.0
        self.setup_peak: Optional[int] = None
        self.window_peak: Optional[int] = None
        self.eval_answers = None
        self.per_layer: Dict[str, float] = {}
        self.trace: Optional[tracing.Trace] = None
        self.cpu_s = 0.0              # the process's CPU seconds in it
        self.pool = self.evalq = None  # the window's and the evaluation's
        self.nb = 0                    # queries; the pool's batches


def measure(system: System, traffic: dict, seconds: float, trace: bool,
            per_layer: List[str], t_start: float) -> Measurement:
    traffic = spec.checked_traffic(traffic)
    b, k = int(traffic["batch"]), int(traffic["k"])
    pool = system.queries(int(traffic["pool_queries"]), data.POOL)
    nb = pool.shape[0] // b
    warm = system.queries(int(traffic["warmup_calls"]) * b, data.WARMUP)
    evalq = system.queries(int(traffic["eval_queries"]), data.EVAL)
    search = system.entry(k)
    t = time.perf_counter()
    for s in range(0, warm.shape[0], b):
        search(warm[s:s + b])
    m = Measurement()
    m.pool, m.evalq, m.nb = pool, evalq, nb
    _sync(system.device)
    system.phases["warmup"] = time.perf_counter() - t
    m.setup_peak = _peak(system.device)
    if m.setup_peak is not None:
        torch.cuda.reset_peak_memory_stats()
    traced_q: list = []
    i = 0

    def call(q, traced=False):
        nonlocal i
        t0 = time.perf_counter()
        if traced:
            m.traced_at.append(i)
            with tracing.call_range():
                out = search(q)
        else:
            out = search(q)
        t1 = time.perf_counter()
        m.answers.append(out)
        m.latency_s.append(t1 - t0)
        i += 1
        return t1

    def stretch():
        _sync(system.device)
        with tracing.capture(system.device) as cap:
            for _ in range(int(traffic["trace_calls"])):
                q = pool[(i % nb) * b:(i % nb + 1) * b]
                traced_q.append(q)
                call(q, traced=True)
                m.traced.append(m.answers[-1])
        m.trace = cap.trace

    start = time.perf_counter()
    m.setup_s = start - t_start
    cpu0 = time.process_time()
    while True:
        if trace and m.trace is None and \
                time.perf_counter() - start >= seconds / 2:
            stretch()
        end = call(pool[(i % nb) * b:(i % nb + 1) * b])
        if end - start >= seconds:
            break
    if trace and m.trace is None:
        stretch()
        end = time.perf_counter()
    m.window_s = end - start
    m.cpu_s = time.process_time() - cpu0
    _sync(system.device)
    m.window_peak = _peak(system.device)
    if trace:
        traced_at = set(m.traced_at)
        ctx = tracing.Context(m.trace, traced_q, m.traced, system.config,
                              traffic, system.collection,
                              [t for j, t in enumerate(m.latency_s)
                               if j not in traced_at])
        for name in per_layer:
            value = spec.reader(name).read(ctx)
            if value is not None:
                m.per_layer[name] = float(value)
    m.eval_answers = checks.stack(
        [search(evalq[s:s + b]) for s in range(0, evalq.shape[0], b)])
    return m


def sampled(m: Measurement, traffic: dict, seed: int
            ) -> Tuple[tuple, np.ndarray]:
    """A sample of the window's answers drawn from the seed, with their
    queries."""
    b = int(traffic["batch"])
    total = len(m.answers) * b
    rng = np.random.default_rng(data.stream_seed(seed, data.SAMPLE))
    pick = np.sort(rng.choice(total, size=min(int(traffic["sample_answers"]),
                                              total), replace=False))
    call, slot = pick // b, pick % b
    ans = tuple(np.stack([m.answers[c][j][s] for c, s in zip(call, slot)])
                for j in range(3))
    q = m.pool[(call % m.nb) * b + slot]
    return ans, q


def judge(system: System, m: Measurement, traffic: dict, seed: int,
          control: bool = False) -> dict:
    """The compared numbers of the program (and, with ``control``, of the
    TF32 reference in its place on the same queries), and recall@k of the
    evaluation set."""
    k = int(traffic["k"])
    metric = system.config["metric"]
    ans, q = sampled(m, traffic, seed)
    allq = np.concatenate([q, m.evalq])
    answers = tuple(np.concatenate([a, e]) for a, e in zip(ans,
                                                          m.eval_answers))
    _, truth = reference.exact_topk(system.corpus, allq, k, metric,
                                    system.device)
    reach = None
    part = system.partition
    if part is not None:
        reach = reference.reachable_topk(system.corpus, allq, k, metric,
                                         system.device, part)
        faults = checks.partition_faults(part["row_table"],
                                         part["overflow_rows"],
                                         system.corpus.shape[0])

    def numbers(rows_of):
        got = checks.compare(rows_of, allq, system.corpus, metric,
                             system.names, truth)
        if reach is not None:
            got["missed_reachable"] = 1.0 - checks.recall(rows_of[2], reach)
            got["partition_faults"] = faults
        return got
    out = {"numbers": numbers(answers),
           "recall": checks.recall(m.eval_answers[2], truth[len(q):])}
    if control:
        out["control"] = numbers(reference.control(
            system.corpus, allq, k, metric, system.device, system.names))
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def device_info(device, chips: int, m: Measurement) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": None}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(m.setup_peak or 0, m.window_peak or 0),
            "power_limit": power_limit()}
    if m.trace is not None:
        info["busy_s"] = m.trace.busy_us / 1e6
        info["window_s"] = m.trace.window_us / 1e6
    return info


def p95_ms(latency_s: List[float]) -> float:
    """The 95th percentile of the calls' latencies, in milliseconds."""
    return float(np.percentile(np.asarray(latency_s), 95)) * 1e3


def end_to_end(m: Measurement, traffic: dict, rows: int,
               recall: float) -> Dict[str, Optional[float]]:
    b = int(traffic["batch"])
    return {
        "qps": len(m.answers) * b / m.window_s,
        "p95_ms": p95_ms(m.latency_s),
        "recall_at_10": recall,
        "device_bytes_per_vector": (m.window_peak / rows
                                    if m.window_peak is not None else None),
        "setup_s": m.setup_s,
    }


def quarters(m: Measurement, traffic: dict) -> List[float]:
    """Queries a second in each quarter of the window (calls by their end),
    to tell drift inside a run from spread between runs."""
    ends = np.cumsum(m.latency_s)
    q = np.minimum((4 * ends / max(ends[-1], 1e-9)).astype(int), 3)
    span = ends[-1] / 4
    return [float((q == j).sum()) * int(traffic["batch"]) / span
            for j in range(4)]


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", overrides: Optional[dict] = None,
        log=sys.stderr) -> Tuple[dict, List[str]]:
    """One run: (the result line's object, the check lines for stderr)."""
    man = spec.manifest()
    wl = spec.workload(man, workload)
    over = overrides or {}
    config = spec.merged(spec.config(man, wl["config"]), over.get("config"))
    traffic = spec.merged(spec.traffic(wl["traffic"]), over.get("traffic"))
    limits = spec.limits(workload)
    wanted = spec.metrics(man, workload, trace)
    system = System(config, seed, device)
    m = measure(system, traffic, seconds, trace,
                [x["name"] for x in wanted] if trace else [], t_start)
    print(f"built: {system.report}", file=log, flush=True)
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   system.phases.items())
          + f"; total {m.setup_s:.3f}; window {m.window_s:.3f} s, "
          f"{len(m.answers)} calls, process CPU {m.cpu_s:.3f} s; "
          "qps by quarter of the window: "
          + " ".join(f"{x:.1f}" for x in quarters(m, traffic)),
          file=log, flush=True)
    system.close()
    t = time.perf_counter()
    verdict = judge(system, m, traffic, seed)
    print(f"reference and checks: {time.perf_counter() - t:.3f} s",
          file=log, flush=True)
    numbers = verdict["numbers"]
    b = int(traffic["batch"])
    failed = sum(int((a[2] < 0).any(axis=1).sum()) for a in m.answers)
    if trace:
        values = m.per_layer
    else:
        values = end_to_end(m, traffic, int(config["rows"]),
                            verdict["recall"])
    metrics = {x["name"]: {"value": values[x["name"]], "unit": x["unit"]}
               for x in wanted if values.get(x["name"]) is not None}
    result = {"correct": checks.verdict(numbers, limits),
              "attempted": len(m.answers) * b, "failed": failed,
              "metrics": metrics,
              "device": device_info(device, int(wl["chips"]), m)}
    if m.trace is not None:
        result["breakdown"] = {"device_ops": m.trace.device_ops(),
                               "idle_gaps": m.trace.idle_gaps()}
    result["checks"] = {name: {"value": numbers[name], "limit": limit}
                        for name, limit in limits.items()}
    lines = [f"check {name}: {numbers[name]!r} (limit {limit!r})"
             for name, limit in limits.items()]
    return result, lines
