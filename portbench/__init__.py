"""The benchmark of the PyTorch and CUDA port (vision_compression_project_tpu_torch).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own, found by the name BENCHMARK.json gives:
configs/<config>.json, traffic/<mix>.json, metrics/<metric>.py and
limits/<cell>.json. A traffic file's `kind` names its module in drivers/.

The yardstick (yardstick/: peaks, operation and byte counts) and the plain
reference (reference/) import nothing of the port and nothing of JAX.
"""
