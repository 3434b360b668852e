"""What decides `correct`: every answer the window returned, against the
reference's answer for its probe batch.

The answers are exact (integer counts and sums), so the comparison is
exact and every limit is 0. The numbers compared:

- `wrong_answers`: the queries whose answer differs from the reference's
  in any field;
- `<field>_gap`, for each answer field: the largest absolute difference,
  over all queries and the field's entries, from the reference.
"""

from __future__ import annotations

LIMIT = 0


def checks(answers: list, refs: list, fields: list) -> dict:
    """{name: {"value": number, "limit": LIMIT}}. `answers` holds (batch,
    {field: [ints]}) a query; `refs[batch]` is the reference's {field:
    [ints]} for that batch."""
    wrong = 0
    gaps = {field: 0 for field in fields}
    for batch, got in answers:
        want = refs[batch]
        differs = False
        for field in fields:
            if len(got[field]) != len(want[field]):
                raise ValueError(f"{field}: {len(got[field])} values, the reference "
                                 f"has {len(want[field])}")
            gap = max(abs(a - b) for a, b in zip(got[field], want[field]))
            gaps[field] = max(gaps[field], gap)
            differs |= gap > 0
        wrong += differs
    out = {"wrong_answers": {"value": wrong, "limit": LIMIT}}
    for field in fields:
        out[f"{field}_gap"] = {"value": gaps[field], "limit": LIMIT}
    return out


def passed(result: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in result.values())


def as_ints(answer: dict, fields: list) -> dict:
    """{field: [ints]} of an answer's tensors."""
    return {field: [int(v) for v in answer[field].reshape(-1).tolist()] for field in fields}
