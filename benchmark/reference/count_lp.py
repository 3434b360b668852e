"""Plain reference of query kind `count_lp`: query kind `count`'s
(`reference/count.py`), since a hash table and a sorted one answer the
same join. Each probe key's matches are the range of equal keys among the
build keys sorted, found by `searchsorted`, in blocks of 2^22 probe rows;
every count and sum is kept in `acc`, int64, or int32 for the control.
It imports nothing of the program."""

from __future__ import annotations

from benchmark.manifest import plugin

answer = plugin("reference", "count").answer
