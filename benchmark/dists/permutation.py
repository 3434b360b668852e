"""The n unique keys lo .. lo + n - 1, in an order drawn from the seed."""

import torch


def draw(gen: torch.Generator, n: int, spec: dict, dtype: torch.dtype) -> torch.Tensor:
    perm = torch.randperm(n, generator=gen, device=gen.device, dtype=torch.int64)
    return (perm + spec.get("lo", 0)).to(dtype)
