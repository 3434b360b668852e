"""What `correct` has to catch: the control, and the faults a query's
timed path can have, each put in the port's place.

- `control`: the reference, computed in int32, the nearest type below
  the int64 that the configuration states for every count and checksum;
- `stale`: a step that returns its state unchanged (every query answers
  with the first query's answer);
- `half`: half of the batch left out, the rest scaled up (the answer
  over the first half of the rows, doubled);
- `altered`: an answer altered where it is produced (the count plus 1).

The exchange between chips has no fault here: every cell runs on one.
Each maker takes (the port's call, the run's inputs, the reference
module) and returns the call that the harness drives.
"""

from __future__ import annotations

import torch


def control(port_call, inputs, reference):
    return lambda batch: reference.answer(inputs.build, batch, acc=torch.int32)


def stale(port_call, inputs, reference):
    first = []

    def call(batch):
        if not first:
            first.append(port_call(batch))
        return first[0]

    return call


def half(port_call, inputs, reference):
    def call(batch):
        out = port_call(batch[: batch.shape[0] // 2])
        return {k: v * 2 for k, v in out.items()}

    return call


def altered(port_call, inputs, reference):
    def call(batch):
        out = dict(port_call(batch))
        out["count"] = out["count"] + 1
        return out

    return call


FAULTS = {"control": control, "stale": stale, "half": half, "altered": altered}
