"""Adaptive control: the bandit-tuned compaction-threshold learner
(reference L2, negative_feedback.hpp), on the host (`bandit`) and on the
device (`device_bandit`)."""

from ccve_tpu_torch.control.bandit import CompactTuner, MultiArmedBandit

__all__ = ["MultiArmedBandit", "CompactTuner"]
