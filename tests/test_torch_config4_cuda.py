"""Slice 8 on the card: the aggregates, the hash partition, the radix sort,
the device CSR build and config 4, each against the same call's CPU path
on the same inputs. Tolerance 0: every output is an integer.

Every test needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor `ccve_tpu`, so on a machine without JAX run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_config4_cuda.py
"""

import numpy as np
import pytest
import torch

from ccve_tpu_torch.bench import configs
from ccve_tpu_torch.core.datagen import gen_rhs_table, gen_zipf_keys
from ccve_tpu_torch.ops import aggregate as agg
from ccve_tpu_torch.ops import hash_table as ht
from ccve_tpu_torch.ops import sort
from ccve_tpu_torch.ops import sort_merge as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _both(a, device):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t, t.to(device)


def _same_result(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), (g, w)


@pytest.mark.parametrize("n, domain", [(1, 1), (5000, 64), (300_000, 100_000)])
def test_aggregates_on_the_card(cuda, n, domain):
    keys_h, keys_d = _both(gen_zipf_keys(n, domain, 1.1), cuda)
    rng = np.random.default_rng(n)
    vals_h, vals_d = _both(rng.integers(-(2**40), 2**40, n, dtype=np.int64), cuda)
    _same_result(agg.hash_aggregate(keys_d, vals_d), agg.hash_aggregate(keys_h, vals_h))
    _same_result(agg.dense_aggregate(keys_d, vals_d, domain),
                 agg.dense_aggregate(keys_h, vals_h, domain))
    for n_parts in (1, 12, 16):
        assert torch.equal(agg.partition_histogram(keys_d, n_parts).cpu(),
                           agg.partition_histogram(keys_h, n_parts))


@pytest.mark.parametrize("n, domain", [(100, 64), (8192, 257), (200_000, 10_000)])
def test_join_dense_aggregate_on_the_card(cuda, n, domain):
    keys, payloads = gen_rhs_table(domain, 1)
    probe_h, probe_d = _both(gen_zipf_keys(n, domain, 1.1), cuda)
    got = agg.join_dense_aggregate(sm.build_sorted(keys, payloads, device=cuda), probe_d, domain)
    want = agg.join_dense_aggregate(sm.build_sorted(keys, payloads, device="cpu"), probe_h,
                                    domain)
    _same_result(got[0], want[0])
    assert int(got[1]) == int(want[1]) == n


@pytest.mark.parametrize("n, bits", [(1, 64), (100_000, 64), (300_001, 17)])
def test_radix_sort_pairs_on_the_card(cuda, n, bits):
    keys_h, keys_d = _both(gen_zipf_keys(n, 100_000, 1.1) if bits < 64 else
                           np.random.default_rng(n).integers(-(2**63), 2**63 - 1, n,
                                                             dtype=np.int64), cuda)
    vals_d = torch.arange(n, device=cuda)
    k, v = sort.radix_sort_pairs(keys_d, vals_d, bits=bits)
    sk, order = keys_d.sort(stable=True)
    assert torch.equal(k, sk) and torch.equal(v, order)
    assert torch.equal(sort.radix_argsort(keys_d, bits=bits).cpu(),
                       sort.radix_argsort(keys_h, bits=bits))


@pytest.mark.parametrize("n, chunk_factor", [(50_000, 1), (100_000, 2)])
def test_build_csr_device_on_the_card(cuda, n, chunk_factor):
    keys, payloads = gen_rhs_table(n, chunk_factor)
    host = ht.build_csr(keys, payloads, device=cuda)
    got = ht.build_csr_device(torch.from_numpy(keys).to(cuda),
                              torch.from_numpy(payloads).to(cuda), host.n_buckets, host.max_len)
    for field in ("offsets", "entry_keys", "entry_payloads"):
        assert torch.equal(getattr(got, field), getattr(host, field)), field


def test_config4_small_on_the_card(cuda):
    got = configs.config4_zipf_pipeline(n_probe=400_000, domain=10_000, device=cuda)
    want = configs.config4_zipf_pipeline(n_probe=400_000, domain=10_000, device="cpu")
    for key in ("matches", "n_groups", "top_group", "partition_hist_16", "partition_skew_16"):
        assert got[key] == want[key], key
    assert got["timer"] == "cuda events"
