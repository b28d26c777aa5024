"""The benchmark of ``msra_practice_project_tpu_torch`` on NVIDIA H100 cards:
``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See README.md."""
