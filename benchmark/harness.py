"""One run of one cell: set-up, the measured window, the judgement and
the result line. `run.py` looks for the card and calls `run_cell`; the
tests call it on the CPU at a tiny size.

The traffic is a closed loop with one client: one analyst who sends a
query, waits for its answer and sends the next. The queries take the
pool's probe batches round robin, from a batch drawn from the seed. A
query runs from the call into the port to its answer on the host: the
harness itself concatenates the answer's fields and copies them with one
`.cpu()`, so no change to the port can thin the answer read. Its latency
is read from two CUDA events, one recorded before the call and one after
the answer came back, both on an idle stream (the loop is closed), so the
device's clock times the host's interval: a query lasts a few
milliseconds, too short an interval for the host's clock to time alone.
The host clock's reading of the same interval goes to the log beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import subprocess
import sys
import time
import warnings
from functools import partial

import torch

from benchmark import judge, roofline, trace
from benchmark.data import make_inputs
from benchmark.manifest import Cell, plugin, reader

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ccve_tpu"})


def forbidden_modules(names) -> list:
    """The loaded modules' top-level names, each taken whole, that are
    JAX or the JAX package (`ccve_tpu_torch` is neither)."""
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


@dataclasses.dataclass
class Run:
    """What a run measured, as the metrics' readers take it."""

    setup_s: float
    window_s: float
    rows: int  # probe rows of the queries answered in the window
    latency_ms: list  # every query's
    phase: list  # every query's: "plain" (in the window), "trace", "spans", "sync"
    entry_ms: list  # every query's host time in the call
    syncs: list  # host syncs in the call, a query of the sync stretch
    least_bytes: int  # a query's, by the query kind's yardstick
    peak_bytes_per_s: float | None
    trace: trace.Trace | None

    def plain(self, values: list) -> list:
        """`values` of the window's queries, which ran neither traced nor
        counted."""
        return [v for v, p in zip(values, self.phase) if p == "plain"]


class _Clock:
    """A query's milliseconds: CUDA events on a GPU, the host clock on the
    CPU (tests only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def _p95(values: list) -> float:
    """The 95th percentile, nearest rank (as `metrics/query_p95_ms.py`)."""
    return sorted(values)[math.ceil(0.95 * len(values)) - 1]


def _read(out: dict, fields: list) -> torch.Tensor:
    """The harness's answer read: every field, concatenated, one copy."""
    return torch.cat([out[f].reshape(-1).to(torch.int64) for f in fields]).cpu()


def _split(host: torch.Tensor, sizes: list, fields: list) -> dict:
    values = host.tolist()
    out, at = {}, 0
    for field, n in zip(fields, sizes):
        out[field] = [int(v) for v in values[at : at + n]]
        at += n
    return out


def _count_syncs(fn):
    """(host syncs, result) of `fn()`, counted from
    `torch.cuda.set_sync_debug_mode`'s warnings."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing" in str(w.message) for w in caught), out


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, for the log."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def _traced(step, device, mix: dict, log) -> trace.Trace:
    """The stretches after a traced run's window: the device's stretch,
    the host's stretch (see `benchmark.trace`), then `sync_queries` with
    the host's syncs counted."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    prof = trace.profiler(device, host=False)
    with prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(mix["trace_queries"]):
            step("trace")
        window_s = time.perf_counter() - t0
    device_events, _ = trace.events(prof)
    prof = trace.profiler(device, host=True)
    with prof:
        for _ in range(trace.SKIP + mix["span_queries"]):
            with torch.profiler.record_function(trace.QUERY):
                step("spans", spans=True)
    gaps = trace.idle_gaps(*trace.events(prof))
    for _ in range(mix["sync_queries"] if device.type == "cuda" else 0):
        step("sync", counted=True)
    reduced = trace.reduce(device_events, mix["trace_queries"], window_s, gaps)
    log(f"trace: {reduced.queries} queries in {window_s:.6f} s, {reduced.ops} device "
        f"ops ({reduced.ops / reduced.queries:g} a query), busy {reduced.busy_s:.6f} s")
    return reduced


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, wrap=None, log=None) -> dict:
    """Run `cell` once and return its result line as a dict. `t0` is the
    host clock at the process's start. `wrap`, when given, puts another
    call in the port's place: `wrap(port_call, inputs, reference)` (the
    control and the faults of `benchmark.faults`)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    mix = cell.mix
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError(f"traffic: only a closed loop of one client is generated, got "
                         f"{mix['loop']!r} with {mix['clients']} clients")
    query = plugin("queries", mix["query"])
    reference = plugin("reference", mix["query"])
    fields = list(mix["answer"])
    inputs = make_inputs(cell.config, mix, seed, device)
    pool, n_pool = inputs.pool, len(inputs.pool)
    t_inputs = time.perf_counter()
    state = query.prepare(inputs.build, device)
    t_tables = time.perf_counter()
    call = partial(query.call, state)
    if wrap is not None:
        call = wrap(call, inputs, reference)
    clock = _Clock(device)
    syncs = []  # host syncs in the call, a query of the sync stretch

    def one(b: int, spans: bool = False, counted: bool = False):
        """(answer, answer on the host, ms, host ms in the call, host ms
        to the answer) of a query of batch b; with `spans` inside the
        harness's profiler spans, with `counted` its host syncs counted."""
        clock.start()
        h0 = time.perf_counter()
        if spans:
            with torch.profiler.record_function(trace.ENTRY):
                out = call(pool[b])
        elif counted:
            n, out = _count_syncs(lambda: call(pool[b]))
            syncs.append(n)
        else:
            out = call(pool[b])
        h1 = time.perf_counter()
        if spans:
            with torch.profiler.record_function(trace.READ):
                host = _read(out, fields)
        else:
            host = _read(out, fields)
        h2 = time.perf_counter()
        return out, host, clock.stop(), (h1 - h0) * 1e3, (h2 - h0) * 1e3

    out, *_ = one(0)
    sizes = [out[f].numel() for f in fields]
    t_first = time.perf_counter()
    for _ in range(mix["warmup_rounds"]):
        for b in range(n_pool):
            one(b)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: inputs at {t_inputs - t0:.3f} s, the port's tables at "
        f"{t_tables - t0:.3f} s, first query at {t_first - t0:.3f} s; pool of {n_pool} "
        f"batches of {tuple(pool[0].shape)} {pool[0].dtype}, first batch {inputs.start}")

    # every query's: (batch, answer on the host), ms, host ms in the call,
    # and where it ran: in the window ("plain") or in a stretch after it
    answers, latency, entry, phase, wall = [], [], [], [], []
    b = inputs.start
    gc.collect()
    gc.freeze()  # set-up's objects: no collection in the window scans them again
    t_open = time.perf_counter()
    deadline = t_open + seconds

    def step(kind: str, **kw):
        nonlocal b
        _, host, ms, host_ms, wall_ms = one(b, **kw)
        answers.append((b, host))
        latency.append(ms)
        entry.append(host_ms)
        wall.append(wall_ms)
        phase.append(kind)
        b = (b + 1) % n_pool

    while time.perf_counter() < deadline:
        step("plain")
    window_s = time.perf_counter() - t_open
    n_plain = len(latency)
    log(f"window: {n_plain} queries; latency ms by events, by the host clock: mean "
        f"{statistics.fmean(latency):.6f}, {statistics.fmean(wall):.6f}; p95 "
        f"{_p95(latency):.6f}, {_p95(wall):.6f}")
    reduced = None
    if traced:  # after the window, so that the profiler's own work is not in it
        reduced = _traced(step, device, mix, log)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")
    record = Run(
        setup_s=setup_s, window_s=window_s,
        rows=phase.count("plain") * pool[0].shape[0],
        latency_ms=latency, phase=phase, entry_ms=entry, syncs=syncs,
        least_bytes=query.least_bytes(inputs.build, pool[0]),
        peak_bytes_per_s=roofline.peak_bytes_per_s(device_name),
        trace=reduced,
    )

    # the program's state goes before the reference runs
    del state, call
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs = [judge.as_ints(reference.answer(inputs.build, batch), fields) for batch in pool]
    got = [(bb, _split(host, sizes, fields)) for bb, host in answers]
    checks = judge.checks(got, refs, fields)
    correct = judge.passed(checks)

    entries = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in entries:
        value = reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(answers),
              "failed": checks["wrong_answers"]["value"], "metrics": metrics,
              "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced.busy_s
        dev["window_s"] = reduced.window_s
        result["breakdown"] = {"device_ops": reduced.device_ops,
                               "idle_gaps": reduced.idle_gaps}
    if device.type == "cuda":
        log(f"card: {card_line()}")
    found = forbidden_modules(sys.modules)
    if found:
        raise RuntimeError(f"the run loaded JAX or the JAX package: {found}")
    result["checks"] = checks
    return result
