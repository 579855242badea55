"""Serving benchmark of ollamamq_tpu_torch: open-loop, many-user HTTP
traffic against the port's server on one card, with a plain float32
reference that decides whether the served tokens are correct.

Entry point: `python3 servebench/run.py --workload NAME --seed N
--seconds S --trace 0|1` (see run.py). Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own under
configs/, traffic/ and metrics/, found by the name BENCHMARK.json gives.
"""
