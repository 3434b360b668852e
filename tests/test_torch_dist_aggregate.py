"""The port's distributed group-by (`parallel.dist_aggregate`) on 2 and 4
gloo ranks, held exactly against the JAX package's on its 8-device CPU
mesh, on the JAX tests' inputs (`tests/test_dist_aggregate.py`): the
global group set, `shard_groups`, `n_groups`, `block_len`, the skew
(float32) and the overflow flag."""

import numpy as np
import pytest

from ccve_tpu.parallel import dist_aggregate as jagg
from ccve_tpu.parallel import distributed as jd

import torch_dist_cases as cases

WORLDS = (2, 4)
NAMES = ("uniform", "zipf", "overflow", "uneven")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return {P: cases.spawn("AGGREGATE_CASES", P, tmp_path_factory.mktemp(f"p{P}"))
            for P in WORLDS}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_dist_aggregate_matches_jax(port, name, P):
    keys, values, slack = cases.aggregate_inputs(name)
    res = jagg.dist_aggregate(jd.make_join_mesh(P), keys, values, cap_slack=slack)
    got = port[P][name]
    assert got["overflow"] == bool(res.overflow)
    assert got["skew"] == float(np.float32(res.skew))
    if got["overflow"]:
        assert name == "overflow"
        return
    assert got["shard_groups"] == np.asarray(res.shard_groups).tolist()
    assert got["n_groups"] == int(res.n_groups)
    assert got["block_len"] == res.block_len
    np.testing.assert_array_equal(got["groups"], jagg.collect_groups(res))
