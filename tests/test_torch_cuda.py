"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them. This
file imports neither JAX nor `ccve_tpu`, so on a machine without JAX run it
without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.kernels import bigsort, merge_scan
from ccve_tpu_torch.ops import sort_merge as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(a, device):
    return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(device)


@pytest.mark.parametrize("tile_log", [1, 4, 11, bigsort.TILE_LOG])
@pytest.mark.parametrize("nt", [1, 3, 13])
def test_sort_tiles_kernel(cuda, tile_log, nt):
    rng = np.random.default_rng(nt * 100 + tile_log)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, nt << tile_log), cuda)
    got = bigsort.sort_tiles_i32(x, tile_log)
    assert torch.equal(got, bigsort.sort_tiles_plain(x, tile_log))


@pytest.mark.parametrize("n", [1, 5, 2049, 10_000, 5 << 13])
@pytest.mark.parametrize("dom", [3, 2**31 - 1])
def test_merge_level_kernel(cuda, n, dom):
    rng = np.random.default_rng(n)
    runs = _i32(rng.integers(0, dom, n), cuda)
    for run_log in range(16):
        got = bigsort.merge_level_i32(runs, run_log)
        runs = bigsort.merge_level_plain(runs, run_log)
        assert torch.equal(got, runs), run_log


@pytest.mark.parametrize("nt", [1, 2, 3, 5, 13])
def test_sort_runs_kernel(cuda, nt):
    rng = np.random.default_rng(nt)
    x = _i32(rng.integers(-(2**31), 2**31 - 1, nt << bigsort.TILE_LOG), cuda)
    for run_log in range(bigsort.TILE_LOG, bigsort.TILE_LOG + 5):
        got = bigsort.sort_runs_i32(x, run_log)
        assert torch.equal(got, bigsort.sort_runs_plain(x, run_log)), run_log


@pytest.mark.parametrize(
    "n, m, dup",
    [(100_000, 30_000, False), (40_000, 70_000, True), (33_333, 100, True), (0, 10, False)],
)
def test_merge_counts_kernel(cuda, n, m, dup):
    rng = np.random.default_rng(n + m)
    dom = max(m, 1000)
    probes = rng.integers(0, dom + 8, n) * 2
    n_pad = n + (-n) % 2048
    p = _i32(np.concatenate([probes, np.full(n_pad - n, 2**31 - 1)]), cuda)
    runs = bigsort.sort_runs_plain(p, 11, 11)
    builds = rng.integers(0, dom, m) if dup else rng.choice(dom, m, replace=False)
    b32 = _i32(np.sort(builds) * 2 + 3, cuda)
    got = merge_scan.merge_counts_i32(runs, 2048, n, b32, m)
    assert torch.equal(got, merge_scan.merge_counts_plain(runs, 2048, n, b32, m))


@pytest.mark.parametrize("chunk_factor", [1, 4])
def test_totals_on_card_match_cpu(cuda, chunk_factor):
    from ccve_tpu_torch.core.datagen import gen_probe_table, gen_rhs_table

    keys, pays = gen_rhs_table(50_000, chunk_factor)
    probe = gen_probe_table(300_000, 1, 50_000)[:, 0]
    for device in (cuda, "cpu"):
        launches = merge_scan.merge_counts_i32.launches
        c, s = sm.sorted_match_totals(sm.build_sorted(keys, pays, device), probe)
        if device == cuda:
            assert merge_scan.merge_counts_i32.launches == launches + 1
            got = (int(c), int(s))
        else:
            assert (int(c), int(s)) == got
