"""Keys scattered over [0, 2^bits) by the bijection i -> (i * A) mod 2^bits,
A odd and fixed (2^40 over the golden ratio, rounded to an odd number), so
that n keys of a table are unique and spread over the whole span.

A build table's spec, `{"bits": b}`, gives the images of a permutation of
0 .. n - 1 drawn from the seed. A probe column's spec also names the
table's row count `keys` and `hit_share`: that share of the rows, rounded
down, are images of whole numbers drawn uniformly from 0 .. keys - 1, so
each is a key of the table; the rest are drawn uniformly over
[0, 2^bits), and match a key only by chance (keys / 2^bits each). The
rows come in an order drawn from the seed.
"""

import torch

A = 0x9E3779B97F  # odd: i -> i * A is a bijection modulo every 2^bits


def _image(i: torch.Tensor, bits: int) -> torch.Tensor:
    # int64 products wrap modulo 2^64, which keeps their low `bits` bits
    return (i * A) & ((1 << bits) - 1)


def draw(gen: torch.Generator, n: int, spec: dict, dtype: torch.dtype) -> torch.Tensor:
    bits = spec["bits"]
    if not 0 < bits <= 62:
        raise ValueError(f"bits {bits}: the keys lie in [0, 2^bits) for 0 < bits <= 62")
    kw = {"generator": gen, "device": gen.device, "dtype": torch.int64}
    if "hit_share" not in spec:
        return _image(torch.randperm(n, **kw), bits).to(dtype)
    hits = int(n * spec["hit_share"])
    keys = torch.cat([_image(torch.randint(0, spec["keys"], (hits,), **kw), bits),
                      torch.randint(0, 1 << bits, (n - hits,), **kw)])
    return keys[torch.randperm(n, **kw)].to(dtype)
