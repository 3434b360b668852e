"""UCB1-tuned multi-armed bandit for dynamic compaction thresholds.

Re-implements the adaptive control layer of the reference
(negative_feedback.hpp:20-260) with the same math:

 - warm start: round-robin each arm `start_sampling=4` times before any
   UCB decision (negative_feedback.hpp:37-45);
 - UCB1-*tuned*: exploration bonus
   sqrt(log t / (n_i + eps) * min(1/4, V_i)) with the variance proxy
   V_i = E[r^2] - E[r]^2 + sqrt(2 log t / (n_i + eps))
   (negative_feedback.hpp:123-127);
 - exponentially-weighted reward updates with the smoothing factor capped
   at 15 (ratio = min(n, 15)/(min(n, 15)+1), negative_feedback.hpp:84-89);
 - non-stationarity detection: every `heartbeat=256` selects, if the just
   updated arm's estimated reward doubled or halved since the previous
   heartbeat, reset all estimates and re-warm
   (negative_feedback.hpp:67-81);
 - per-heartbeat history for CSV export (negative_feedback.hpp:99-120).

This is host-side control logic (it runs between segments and hands the
next thresholds to the executor), so plain Python is the right tool.

A copy of `ccve_tpu.control.bandit` (pure Python there too): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import os


class MultiArmedBandit:
    """UCB1-tuned bandit (negative_feedback.hpp:20-163)."""

    EPSILON = 0.1
    START_SAMPLING = 4
    HEARTBEAT = 256

    def __init__(self, n_arms: int, means=None):
        self.n_arms = n_arms
        self.est_rewards = list(means) if means is not None else [0.0] * n_arms
        self.est_square_rewards = [0.0] * n_arms
        self.n_select = [0] * n_arms
        self.select_times = 0
        self.stage_update_times = 0
        self.stage_n_update = [0] * n_arms
        self.n_start_sampling = 0
        self._r_means: list | None = None
        self.history: list[tuple[list, list]] = []

    def select_arm(self) -> int:
        if self.n_start_sampling < self.n_arms * self.START_SAMPLING:
            arm = self.n_start_sampling % self.n_arms
            self.n_start_sampling += 1
            self.select_times += 1
            self.n_select[arm] += 1
            return arm

        max_value, max_arm = -1.0, 0
        for i in range(self.n_arms):
            value = self.est_rewards[i] + self._ucb_tuned(i)
            if value > max_value:
                max_value, max_arm = value, i
        self.select_times += 1
        self.n_select[max_arm] += 1
        return max_arm

    def _ucb_tuned(self, arm: int) -> float:
        t = self.stage_update_times
        n = self.stage_n_update[arm] + self.EPSILON
        log_t = math.log(t) if t > 0 else float("-inf")
        var = (
            self.est_square_rewards[arm]
            - self.est_rewards[arm] * self.est_rewards[arm]
            + math.sqrt(2 * log_t / n)
            if t > 0
            else float("nan")
        )
        inner = log_t / n * min(0.25, var)
        # matches C++ sqrt() domain behavior loosely: guard the nan/neg case
        return math.sqrt(inner) if inner == inner and inner >= 0 else 0.0

    def greedy_arm(self) -> int:
        """Exploit-only pick: best estimated reward, no counters touched.
        Used for the NON-explored levels under coordinate exploration
        (exec/pipeline.run): the reference times every level on the host
        per call (main.cpp:143-167 — its executor is synchronous), but a
        segment of device work yields ONE segment time, so only
        one level's bandit explores (and is credited) per segment while
        the rest hold their current best arm."""
        return max(range(self.n_arms), key=lambda i: self.est_rewards[i])

    def update_arm(self, arm: int, reward: float) -> None:
        # heartbeat: change detection + history (negative_feedback.hpp:67-81)
        if (
            self.select_times % self.HEARTBEAT == 0
            and self.n_start_sampling >= self.n_arms * self.START_SAMPLING
        ):
            self.history.append((list(self.est_rewards), list(self.n_select)))
            if self._r_means is None:
                self._r_means = list(self.est_rewards)
            detected = (
                self.est_rewards[arm] > self._r_means[arm] * 2
                or self.est_rewards[arm] < self._r_means[arm] / 2
            )
            self._r_means = list(self.est_rewards)
            if detected:
                self.n_start_sampling = 0
                self.est_rewards = [0.0] * self.n_arms
                self.est_square_rewards = [0.0] * self.n_arms
                self.stage_update_times = 0
                self.stage_n_update = [0] * self.n_arms

        factor = min(self.stage_n_update[arm], 15)
        ratio = factor / (factor + 1.0)
        self.est_rewards[arm] = self.est_rewards[arm] * ratio + reward * (1 - ratio)
        self.est_square_rewards[arm] = (
            self.est_square_rewards[arm] * ratio + reward * reward * (1 - ratio)
        )
        self.stage_update_times += 1
        self.stage_n_update[arm] += 1

    def log_to_csv(self, path: str) -> None:
        """History CSV, one row per heartbeat (negative_feedback.hpp:99-120)."""
        with open(path, "w") as f:
            for i, (rewards, selects) in enumerate(self.history):
                cells = [str(i * self.HEARTBEAT)]
                cells += [repr(r) for r in rewards]
                cells += [str(s) for s in selects]
                f.write(", ".join(cells) + ", \n")


class CompactTuner:
    """Registry of bandits over compaction-threshold arms, one per pipeline
    level (negative_feedback.hpp:165-260). Not a singleton — the engine
    passes an instance around; `CompactTuner.get()` offers the reference's
    singleton access for drivers that want it."""

    _instance: "CompactTuner | None" = None

    def __init__(self):
        self._index: dict[int, int] = {}
        self._bandits: list[MultiArmedBandit] = []
        self._values: list[list[int]] = []
        self._value_index: list[dict[int, int]] = []

    @classmethod
    def get(cls) -> "CompactTuner":
        if cls._instance is None:
            cls._instance = CompactTuner()
        return cls._instance

    def initialize(
        self,
        key: int,
        arms=(0, 32, 64, 128, 256, 384, 512, 768, 1024),
    ) -> None:
        assert key not in self._index
        self._index[key] = len(self._bandits)
        arms = list(arms)
        self._bandits.append(MultiArmedBandit(len(arms), [0.0] * len(arms)))
        self._values.append(arms)
        self._value_index.append({v: i for i, v in enumerate(arms)})

    def select_arm(self, bandit_id: int) -> int:
        """Returns the threshold VALUE for this level's next segment."""
        return self._values[bandit_id][self._bandits[bandit_id].select_arm()]

    def greedy_arm(self, bandit_id: int) -> int:
        """Exploit-only threshold VALUE (see MultiArmedBandit.greedy_arm)."""
        return self._values[bandit_id][self._bandits[bandit_id].greedy_arm()]

    def update_arm(self, bandit_id: int, threshold: int, reward: float) -> None:
        idx = self._value_index[bandit_id].get(threshold)
        if idx is None:
            return
        self._bandits[bandit_id].update_arm(idx, reward)

    def get_id(self, key: int) -> int:
        return self._index.get(key, -1)

    def bandit_size(self) -> int:
        return len(self._bandits)

    def reset(self, enable_log: bool = False, log_dir: str | None = None) -> None:
        if self._bandits and enable_log:
            log_dir = log_dir or "./bandit_log"
            os.makedirs(log_dir, exist_ok=True)
            for key, bid in self._index.items():
                self._bandits[bid].log_to_csv(
                    os.path.join(log_dir, f"bandit_{key}_id{bid}.csv")
                )
        self._index.clear()
        self._bandits.clear()
        self._values.clear()
        self._value_index.clear()
