"""portbench: the benchmark of ``grape_vector_db_tpu_torch`` on an NVIDIA H100.

Run one cell with ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root (README.md)."""
