"""The table of peaks that the rooflines are read against.

NVIDIA's data sheet for the H100 SXM5 80 GB (HBM3): 3.35 TB/s of device
memory bandwidth at its 700 W limit. A card that is not in the table gets
no roofline: its readers return nothing.
"""

from __future__ import annotations

# name that `torch.cuda.get_device_name()` gives -> device memory bytes/s
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(device_name: str) -> float | None:
    return PEAK_BYTES_PER_S.get(device_name)
