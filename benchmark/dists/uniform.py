"""Keys drawn uniformly from the whole numbers in [lo, hi], both ends
included (the source's `uniform_int_distribution(lo, hi)`)."""

import torch


def draw(gen: torch.Generator, n: int, spec: dict, dtype: torch.dtype) -> torch.Tensor:
    return torch.randint(spec["lo"], spec["hi"] + 1, (n,), generator=gen,
                         device=gen.device, dtype=dtype)
