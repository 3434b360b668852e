"""The benchmark of `ccve_tpu_torch`, the PyTorch and CUDA port.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON line. See README.md in this folder.
"""
