"""Runnable benchmark configurations (BASELINE.json), ported one by one.

Ported: config 1, the single equi-join of 1M build rows against 16M
probe rows drawn uniformly from [0, n_build], with the sort-merge engine.
The other configurations and engines wait on their slices (ROADMAP
Queue 1, slice 10).
"""

from __future__ import annotations

import time

import numpy as np
import torch


def numpy_totals(keys: np.ndarray, payloads: np.ndarray, probe: np.ndarray):
    """(count, checksum) of the join of `probe` against (keys, payloads),
    computed in numpy from per-key ranges of the sorted build keys."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    prefix = np.concatenate([[0], np.cumsum(payloads[order], dtype=np.int64)])
    lo = np.searchsorted(sk, probe, side="left")
    hi = np.searchsorted(sk, probe, side="right")
    return int((hi - lo).sum()), int((prefix[hi] - prefix[lo]).sum())


def require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: run on a machine with a GPU, or ask for the "
            "plain CPU path explicitly (device='cpu')"
        )
    return device


TIME_REPS = 3  # timed calls after the warm-up; the best one is reported


def time_call(fn, device: torch.device):
    """(best seconds of TIME_REPS timed calls after one warm-up, last
    result). On a GPU each call is timed with CUDA events; on the CPU with
    the host clock."""
    out = fn()
    best = float("inf")
    for _ in range(TIME_REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best, out


def config1_data(n_build: int, n_probe: int, device: torch.device):
    """Config 1's inputs on `device`: (build table, probe column [n, 1]
    int32, numpy's (count, checksum) of their join)."""
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table
    from ccve_tpu_torch.ops.sort_merge import build_sorted

    keys, payloads = gen_rhs_table(n_build, 1)
    probe = gen_probe_table(n_probe, 1, n_build)
    table = build_sorted(keys, payloads, device=device)
    # keys <= n_build < 2^31: the narrow column skips the int64 pack
    probe_dev = torch.from_numpy(probe.astype(np.int32)).to(device)
    return table, probe_dev, numpy_totals(keys, payloads, probe[:, 0])


def config1_single_join(
    n_build: int = 1_000_000,
    n_probe: int = 16_000_000,
    engine: str = "sort_merge",
    device="cuda",
) -> dict:
    """Config 1: `bulk_count` of the single join, timed after a warm-up,
    with count and checksum asserted against numpy."""
    from ccve_tpu_torch.exec.bulk import bulk_count

    if engine != "sort_merge":
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (ROADMAP Queue 1, slice 5)"
        )
    device = require_device(device)
    table, probe_dev, expected = config1_data(n_build, n_probe, device)
    seconds, res = time_call(lambda: bulk_count([table], probe_dev), device)
    count, checksum = int(res.count), int(res.payload_checksums[0])
    if (count, checksum) != expected:
        raise AssertionError(f"(count, checksum) {(count, checksum)} != numpy {expected}")
    return {
        "name": "config1_single_join",
        "engine": engine,
        "device": (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        ),
        "timer": "cuda events" if device.type == "cuda" else "host clock",
        "n_build": n_build,
        "n_probe": n_probe,
        "seconds": seconds,
        "rows_per_s": n_probe / seconds,
        "count": count,
        "checksum": checksum,
    }


ALL_CONFIGS = {1: config1_single_join}
