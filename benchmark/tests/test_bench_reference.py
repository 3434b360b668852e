"""The plain reference against hand-worked joins and a nested-loop join."""

import itertools

import pytest
import torch

from benchmark.manifest import plugin

reference = plugin("reference", "count")


def _t(values):
    return torch.tensor(values, dtype=torch.int64)


def _answer(build, probe, acc=torch.int64):
    r = reference.answer([(_t(k), _t(p)) for k, p in build],
                         torch.tensor(probe, dtype=torch.int32), acc=acc)
    return int(r["count"]), [int(c) for c in r["payload_checksums"]]


def _nested_loops(build, probe):
    """Every output row of the chained join, enumerated."""
    count, sums = 0, [0] * len(build)
    for row in probe:
        matches = [[p for k, p in zip(*build[lv]) if k == row[lv]]
                   for lv in range(len(build))]
        for out in itertools.product(*matches):
            count += 1
            for lv, pay in enumerate(out):
                sums[lv] += pay
    return count, sums


def test_one_level_duplicates_missing_and_negative_payloads():
    # keys 3 twice (10 + 20), 1 once (-5), 7 once (1); probe 2 misses
    build = [([3, 1, 3, 7], [10, -5, 20, 1])]
    probe = [[3], [3], [2], [7], [1]]
    assert _answer(build, probe) == (6, [30 + 30 + 1 - 5])


def test_one_level_no_match_gives_zero():
    assert _answer([([5, 6], [1, 2])], [[0], [9]]) == (0, [0])


def test_four_levels_hand_worked():
    build = [([1, 1, 2], [100, 200, 300]),  # key 1 twice
             ([5], [-7]),
             ([8, 9], [1, 2]),
             ([4, 4, 4], [10, 20, 30])]  # key 4 three times
    # row 0: 2 * 1 * 1 * 3 = 6 rows; row 1 misses level 1; row 2: 1 * 1 * 1 * 3
    probe = [[1, 5, 9, 4], [1, 6, 9, 4], [2, 5, 8, 4]]
    count = 6 + 3
    sums = [(100 + 200) * 3 + 300 * 3,
            -7 * 6 + -7 * 3,
            2 * 6 + 1 * 3,
            (10 + 20 + 30) * 2 + (10 + 20 + 30) * 1]
    assert _answer(build, probe) == (count, sums)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("levels", [1, 2, 4])
def test_against_nested_loops(seed, levels):
    g = torch.Generator().manual_seed(seed * 10 + levels)
    build = []
    for _ in range(levels):
        m = int(torch.randint(1, 12, (1,), generator=g))
        keys = torch.randint(-3, 6, (m,), generator=g).tolist()  # duplicates
        pays = torch.randint(-50, 50, (m,), generator=g).tolist()
        build.append((keys, pays))
    probe = torch.randint(-4, 7, (20, levels), generator=g).tolist()
    assert _answer(build, probe) == _nested_loops(build, probe)


def test_blocks_add_up(monkeypatch):
    build = [([0, 1, 2, 2], [5, 6, 7, 8]), ([2, 1], [3, 4])]
    probe = [[i % 4, i % 3] for i in range(37)]
    whole = _answer(build, probe)
    monkeypatch.setattr(reference, "BLOCK_ROWS", 5)
    assert _answer(build, probe) == whole == _nested_loops(build, probe)


def test_int32_control_wraps_past_two_to_the_31():
    build = [([0, 1], [10_000_000, 10_000_001])]
    probe = [[i % 2] for i in range(400)]
    exact = _answer(build, probe)
    assert exact[1][0] > 2**31
    assert _answer(build, probe, acc=torch.int32) != exact
