"""The port's bandits (`control.bandit`, `control.device_bandit`) against the
JAX package's on the same reward sequences: the host bandit's arms,
estimates and history exactly (the same Python float math), the device
bandit's arms, counters and commits exactly and its float32 estimates at
rtol 1e-6 (`log` and `sqrt` may differ by an ulp between XLA on the CPU and
torch), after every round."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.control import bandit as jax_bandit
from ccve_tpu.control import device_bandit as jax_db
from ccve_tpu_torch.control import bandit, device_bandit as db

FLOAT_FIELDS = ("est", "est_sq", "r_means")


def _rewards(rng, n_arms, rounds, jump_at):
    """A reward table [rounds, n_arms]: noisy arm means that triple at
    `jump_at`, so the heartbeat's change detection fires."""
    means = rng.uniform(0.1, 1.0, n_arms)
    table = means + 0.02 * rng.standard_normal((rounds, n_arms))
    table[jump_at:] *= 3.0
    return table


@pytest.mark.parametrize("n_arms, rounds", [(2, 300), (4, 700), (9, 1100)])
def test_host_bandit_matches_jax(n_arms, rounds):
    rng = np.random.default_rng(n_arms)
    table = _rewards(rng, n_arms, rounds, jump_at=rounds // 2)
    ours, theirs = bandit.MultiArmedBandit(n_arms), jax_bandit.MultiArmedBandit(n_arms)
    resets = 0
    for step in range(rounds):
        arm = ours.select_arm()
        assert arm == theirs.select_arm(), step
        assert ours.greedy_arm() == theirs.greedy_arm()
        before = ours.n_start_sampling
        ours.update_arm(arm, float(table[step, arm]))
        theirs.update_arm(arm, float(table[step, arm]))
        resets += ours.n_start_sampling < before
        assert ours.est_rewards == theirs.est_rewards
        assert ours.est_square_rewards == theirs.est_square_rewards
        assert ours.n_select == theirs.n_select
    assert ours.history == theirs.history
    if rounds > 2 * bandit.MultiArmedBandit.HEARTBEAT:
        assert resets > 0  # the tripled reward was detected


def test_compact_tuner_matches_jax(tmp_path):
    arms = (0, 32, 64, 128)
    ours, theirs = bandit.CompactTuner(), jax_bandit.CompactTuner()
    for t in (ours, theirs):
        for level in range(3):
            t.initialize(level, arms)
    rng = np.random.default_rng(5)
    for step in range(600):
        level = step % 3
        thr = ours.select_arm(level)
        assert thr == theirs.select_arm(level)
        assert [ours.greedy_arm(lv) for lv in range(3)] == \
            [theirs.greedy_arm(lv) for lv in range(3)]
        reward = float(rng.uniform(0.5, 1.5) * (1 + arms.index(thr)) * (2 if step > 300 else 1))
        ours.update_arm(level, thr, reward)
        theirs.update_arm(level, thr, reward)
    ours.update_arm(0, 999, 1.0)  # a threshold that is no arm is ignored
    assert ours.bandit_size() == theirs.bandit_size() == 3
    assert (ours.get_id(1), ours.get_id(7)) == (theirs.get_id(1), theirs.get_id(7)) == (1, -1)
    ours.reset(enable_log=True, log_dir=str(tmp_path / "ours"))
    theirs.reset(enable_log=True, log_dir=str(tmp_path / "theirs"))
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir()) and names
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()
    assert ours.bandit_size() == 0


_JAX_SELECT = jax.jit(jax_db.select_arms, static_argnums=1)
_JAX_UPDATE = jax.jit(jax_db.update_arms, static_argnums=(3, 4))


def _same_state(ours, theirs, what):
    for name in jax_db.DeviceBanditState._fields:
        got, want = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        assert got.dtype == want.dtype, (what, name)
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")


@pytest.mark.parametrize("n_levels, n_arms, start_sampling, commit_after", [
    (2, 2, 2, 8), (3, 4, 4, 0), (4, 9, 2, 0), (2, 5, 4, 8),
])
def test_device_bandit_matches_jax(n_levels, n_arms, start_sampling, commit_after):
    """600 select/update rounds on per-level reward tables that triple at
    round 300 (so the heartbeat at select 512 sees it): the states must
    match after every round."""
    rounds = 600
    rng = np.random.default_rng(10 * n_levels + n_arms)
    tables = [_rewards(rng, n_arms, rounds, jump_at=300) for _ in range(n_levels)]
    ours = db.init_state(n_levels, n_arms, device="cpu")
    theirs = jax_db.init_state(n_levels, n_arms)
    _same_state(ours, theirs, "init")
    committed = detected = 0
    for step in range(rounds):
        arm, ours = db.select_arms(ours, start_sampling)
        j_arm, theirs = _JAX_SELECT(theirs, start_sampling)
        np.testing.assert_array_equal(arm.numpy(), np.asarray(j_arm), err_msg=f"round {step}")
        reward = np.array([tables[lv][step, a] for lv, a in enumerate(arm.tolist())],
                          np.float32)
        n_start = ours.n_start.clone()
        ours = db.update_arms(ours, arm, torch.from_numpy(reward), start_sampling, commit_after)
        theirs = _JAX_UPDATE(theirs, j_arm, jnp.asarray(reward), start_sampling, commit_after)
        _same_state(ours, theirs, f"round {step}")
        committed += int((ours.committed >= 0).sum())
        detected += int((ours.n_start < n_start).sum())
    assert detected > 0  # the tripled rewards reset some level
    if commit_after:
        assert committed > 0


def test_device_bandit_stays_on_device_types():
    """Every field keeps its dtype and device through a round, and ties at
    the start go to the first arm, as jnp.argmax breaks them."""
    st = db.init_state(3, 4, device="cpu")
    arm, st = db.select_arms(st, start_sampling=1)
    assert arm.tolist() == [0, 0, 0] and arm.dtype == torch.int32
    st = db.update_arms(st, arm, torch.ones(3), start_sampling=1)
    for name, t in zip(st._fields, st):
        assert t.dtype == (torch.float32 if name in FLOAT_FIELDS else torch.int32), name
