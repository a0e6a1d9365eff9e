"""The benchmark of ``idunno_tpu_torch`` on one NVIDIA H100.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell and its metrics in
``BENCHMARK.json`` at the root of the checkout, the model in
``perfbench/configs/<config>.json``, the traffic mix in
``perfbench/traffic/<traffic>.json`` (whose ``driver`` names the loop in
``perfbench/drivers/``), the limits of the output check in
``perfbench/limits/<cell>.json`` and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``. The plain references that decide
``correct`` live in ``perfbench/reference/`` and import nothing of the
program.
"""
