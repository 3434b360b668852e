"""The expansion's candidates (`kernels.merge_scan.expand_candidates_i32`,
csrc/candidates.cu) on the CPU: a model in numpy of the kernel's design
held exactly against the plain version, the wrapper's checks, its plain
path on CPU tensors, and the routes that carry the step. The card's tests
are in tests/test_torch_cuda.py. Tolerance 0: integers."""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.bench.edge_cases import CANDIDATE_KINDS, candidates_case
from ccve_tpu_torch.kernels import merge_scan
from ccve_tpu_torch.ops import sort_merge as sm

TILE = 64  # the cases' lengths, shrunk from the kernel's 4096


def _case(kind):
    return candidates_case(np.random.default_rng(25), kind, TILE)


def combine(a, b):
    """seg_scan.cuh's Seg::combine: (start, count, sum), restarting at b's
    run start."""
    return (a[0] | b[0], b[1] if b[0] else a[1] + b[1], b[2] if b[0] else a[2] + b[2])


def model(s, v, fan_out):
    """The kernel's arithmetic: each element is the segment (run start,
    build, its position at a run start and 0 elsewhere), so the carried
    sum is the latest run start's position; a probe's run count is its
    run's builds, and its (f+1)-th build sits at the run start + f (builds
    precede probes in a run). The payload plane is 0 off the valid slots;
    the total sums the probes' counts."""
    L = s.size
    key, probe = s >> 1, (s & 1) == 1
    planes = np.zeros((3, fan_out, L), np.int64)
    planes[0], planes[1] = v, key
    valid = np.zeros((fan_out, L), bool)
    total, run = 0, (0, 0, 0)
    for i in range(L):
        start = int(i == 0 or key[i] != key[i - 1])
        run = combine(run, (start, int(not probe[i]), i if start else 0))
        count = run[1] if probe[i] else 0
        total += count
        for f in range(min(count, fan_out)):
            planes[2, f, i] = v[run[2] + f]
            valid[f, i] = True
    return planes.reshape(3, -1), valid.reshape(-1), total


@pytest.mark.parametrize("kind", CANDIDATE_KINDS)
def test_model_matches_the_plain_version(kind):
    s, v, fan_out = _case(kind)
    planes, valid, total = model(s, v, fan_out)
    want = merge_scan.expand_candidates_plain(torch.from_numpy(s), torch.from_numpy(v), fan_out)
    assert np.array_equal(valid, want[1].numpy())
    assert np.array_equal(planes[:2], want[0][:2].numpy())  # every slot
    assert np.array_equal(planes[:, valid], want[0][:, valid].numpy())
    assert total == int(want[2]) and want[2].dtype == torch.int64


def _i32(n):
    return torch.arange(n, dtype=torch.int32)


BAD = {
    "int64 stream": (lambda: (_i32(8).long(), _i32(8), 1), TypeError),
    "int64 cargo": (lambda: (_i32(8), _i32(8).long(), 1), TypeError),
    "2-D stream": (lambda: (_i32(8).reshape(2, 4), _i32(8), 1), ValueError),
    "strided stream": (lambda: (_i32(16)[::2], _i32(8), 1), ValueError),
    "lengths differ": (lambda: (_i32(8), _i32(7), 1), ValueError),
    "fan-out 0": (lambda: (_i32(8), _i32(8), 0), ValueError),
    "fan-out x L = 2^31": (lambda: (_i32(8), _i32(8), 2**28), ValueError),
    "not a tensor": (lambda: (np.arange(8, dtype=np.int32), _i32(8), 1), TypeError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_checks_raise(bad):
    args, error = BAD[bad]
    with pytest.raises(error):
        merge_scan.expand_candidates_i32(*args())


@pytest.mark.parametrize("kind", ["runs of 1 to 3 builds", "L=1, a probe"])
def test_a_cpu_tensor_takes_the_plain_path(kind):
    s, v, fan_out = _case(kind)
    s, v = torch.from_numpy(s), torch.from_numpy(v)
    before = merge_scan.expand_candidates_i32.launches
    got = merge_scan.expand_candidates_i32(s, v, fan_out)
    want = merge_scan.expand_candidates_plain(s, v, fan_out)
    assert merge_scan.expand_candidates_i32.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_both_routes_carry_the_step():
    assert sm.KERNELS.candidates is merge_scan.expand_candidates_i32
    assert sm.PLAIN.candidates is merge_scan.expand_candidates_plain
    rng = np.random.default_rng(4)
    keys = np.sort(np.repeat(rng.choice(300, 200, replace=False), 3))
    table = sm.build_sorted(keys, rng.integers(-(2**31), 2**31, keys.size), device="cpu")
    probe = torch.from_numpy(rng.integers(-3, 305, 2000))
    got = sm.expand_candidates(table, probe)
    want = sm.expand_candidates(table, probe, route=sm.PLAIN)
    assert got[0].shape == (3, 3 * (2000 + keys.size)) and got[0].dtype == torch.int32
    assert all(torch.equal(g, w) for g, w in zip(got, want))
