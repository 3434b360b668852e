"""The DYNAMIC compaction tuner's bandit on the device.

Port of `ccve_tpu.control.device_bandit`: the reference's UCB1-tuned bandit
(negative_feedback.hpp:20-260; `control.bandit` carries the citations)
vectorized over pipeline levels as torch ops on the pipeline's device, so
the select -> run segment -> update loop needs no host read between
segments. The executor counts work units per level (level entries plus
compactions); the reward of a segment comes from their deltas, and every
value here stays a device tensor: no `.item()`, no `int(...)`.

Two changes to the reference's math, kept from the JAX module:

 - a configurable warm start (`start_sampling`, default 2 against the
   reference's kStartSampling = 4, negative_feedback.hpp:37-45);
 - early commit: once the warm start is done and the greedy arm has stayed
   the same for `commit_after` updates in a row, the level commits and
   selection is pure exploit. The heartbeat change detector still fires on
   the committed arm's reward (doubled or halved), which uncommits and
   warms up again (negative_feedback.hpp:67-81).

The state is a NamedTuple of [n_levels, n_arms] and [n_levels] tensors; all
ops are branch-free selects. `torch.argmax` breaks ties to the first index,
as `jnp.argmax` does: at the start every estimate is 0.0, so ties are the
rule.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ccve_tpu_torch.device import require_device

EPSILON = 0.1
START_SAMPLING = 2  # default; the reference's value is 4
COMMIT_AFTER = 8
HEARTBEAT = 256
EW_CAP = 15


class DeviceBanditState(NamedTuple):
    est: torch.Tensor  # float32[L, A] estimated rewards
    est_sq: torch.Tensor  # float32[L, A]
    n_upd: torch.Tensor  # int32[L, A] stage update counts per arm
    t_upd: torch.Tensor  # int32[L] stage update totals
    n_sel: torch.Tensor  # int32[L, A] lifetime selects per arm
    sel_times: torch.Tensor  # int32[L]
    n_start: torch.Tensor  # int32[L] warm-start progress
    r_means: torch.Tensor  # float32[L, A] estimates at the last heartbeat
    hb_seen: torch.Tensor  # int32[L] heartbeat snapshot taken yet
    committed: torch.Tensor  # int32[L] committed arm, -1 = still exploring
    streak: torch.Tensor  # int32[L] updates in a row with the same greedy arm
    last_greedy: torch.Tensor  # int32[L]
    commit_t: torch.Tensor  # int32[L] sel_times at commit (-1 = never)


def init_state(n_levels: int, n_arms: int, device="cuda") -> DeviceBanditState:
    device = require_device(device)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    return DeviceBanditState(
        est=f32(n_levels, n_arms),
        est_sq=f32(n_levels, n_arms),
        n_upd=i32(n_levels, n_arms),
        t_upd=i32(n_levels),
        n_sel=i32(n_levels, n_arms),
        sel_times=i32(n_levels),
        n_start=i32(n_levels),
        r_means=f32(n_levels, n_arms),
        hb_seen=i32(n_levels),
        committed=i32(n_levels, fill=-1),
        streak=i32(n_levels),
        last_greedy=i32(n_levels, fill=-1),
        commit_t=i32(n_levels, fill=-1),
    )


def _take(x: torch.Tensor, arm: torch.Tensor) -> torch.Tensor:
    """x[l, arm[l]] for each level (`take_along_axis`)."""
    return torch.gather(x, 1, arm[:, None].long())[:, 0]


def select_arms(st: DeviceBanditState, start_sampling: int = START_SAMPLING):
    """(arm indices int32[L], state): the committed arm if any, else the
    warm-start round robin, then the UCB1-tuned argmax
    (negative_feedback.hpp:34-61)."""
    L, A = st.est.shape
    warm = st.n_start < A * start_sampling
    arm_warm = st.n_start % A

    t = st.t_upd.to(torch.float32)[:, None]
    n = st.n_upd.to(torch.float32) + EPSILON
    log_t = torch.where(t > 0, torch.log(torch.clamp(t, min=1.0)),
                        torch.full_like(t, -math.inf))
    var = st.est_sq - st.est * st.est + torch.sqrt(torch.clamp(2.0 * log_t / n, min=0.0))
    inner = log_t / n * torch.clamp(var, max=0.25)
    bonus = torch.where(torch.isfinite(inner) & (inner >= 0), torch.sqrt(torch.abs(inner)),
                        torch.zeros_like(inner))
    arm_ucb = torch.argmax(st.est + bonus, dim=1).to(torch.int32)

    arm = torch.where(warm, arm_warm, arm_ucb)
    arm = torch.where(st.committed >= 0, st.committed, arm)
    onehot = F.one_hot(arm.long(), A).to(torch.int32)
    return arm, st._replace(
        n_start=st.n_start + (warm & (st.committed < 0)).to(torch.int32),
        sel_times=st.sel_times + 1,
        n_sel=st.n_sel + onehot,
    )


def update_arms(st: DeviceBanditState, arm: torch.Tensor, reward: torch.Tensor,
                start_sampling: int = START_SAMPLING,
                commit_after: int = COMMIT_AFTER) -> DeviceBanditState:
    """The EW update and heartbeat change detection for each level's chosen
    arm (negative_feedback.hpp:67-97), and the early-commit tracker.
    `commit_after <= 0` never commits (the reference's behaviour)."""
    L, A = st.est.shape
    onehot = F.one_hot(arm.long(), A).to(torch.float32)

    # the heartbeat, before the update, as in the reference
    at_hb = (st.sel_times % HEARTBEAT == 0) & (st.n_start >= A * start_sampling)
    cur = _take(st.est, arm)
    ref = _take(st.r_means, arm)
    detected = at_hb & (st.hb_seen > 0) & ((cur > ref * 2) | (cur < ref / 2))
    r_means = torch.where(at_hb[:, None], st.est, st.r_means)
    hb_seen = torch.where(at_hb, torch.ones_like(st.hb_seen), st.hb_seen)

    reset = detected[:, None]
    est = torch.where(reset, torch.zeros_like(st.est), st.est)
    est_sq = torch.where(reset, torch.zeros_like(st.est_sq), st.est_sq)
    n_upd = torch.where(reset, torch.zeros_like(st.n_upd), st.n_upd)
    t_upd = torch.where(detected, torch.zeros_like(st.t_upd), st.t_upd)
    n_start = torch.where(detected, torch.zeros_like(st.n_start), st.n_start)

    # the EW update of the chosen arm
    factor = torch.clamp(_take(n_upd, arm), max=EW_CAP).to(torch.float32)
    ratio = factor / (factor + 1.0)
    new_est_arm = _take(est, arm) * ratio + reward * (1 - ratio)
    new_sq_arm = _take(est_sq, arm) * ratio + reward * reward * (1 - ratio)
    est = est * (1 - onehot) + onehot * new_est_arm[:, None]
    est_sq = est_sq * (1 - onehot) + onehot * new_sq_arm[:, None]

    # early commit: a change-detection reset uncommits and restarts the
    # streak; the streak accrues only over greedy selections after the warm
    # start (an argmax of half-filled estimates must not count toward it)
    greedy = torch.argmax(est, dim=1).to(torch.int32)
    warm_done = n_start >= A * start_sampling
    streak = torch.where(
        warm_done,
        torch.where(greedy == st.last_greedy, st.streak + 1, torch.ones_like(st.streak)),
        torch.zeros_like(st.streak),
    )
    commit_now = warm_done & (st.committed < 0) & (streak >= commit_after) & ~detected
    if commit_after <= 0:
        commit_now = torch.zeros_like(commit_now)
    minus1 = torch.full_like(st.committed, -1)
    committed = torch.where(detected, minus1, st.committed)
    committed = torch.where(commit_now, greedy, committed)
    commit_t = torch.where(commit_now, st.sel_times, st.commit_t)
    streak = torch.where(detected, torch.zeros_like(streak), streak)
    last_greedy = torch.where(detected, minus1, greedy)

    return DeviceBanditState(
        est=est,
        est_sq=est_sq,
        n_upd=n_upd + onehot.to(torch.int32),
        t_upd=t_upd + 1,
        n_sel=st.n_sel,
        sel_times=st.sel_times,
        n_start=n_start,
        r_means=r_means,
        hb_seen=hb_seen,
        committed=committed,
        streak=streak,
        last_greedy=last_greedy,
        commit_t=commit_t,
    )
