"""The benchmark of ``fastpyvectordb_tpu_torch`` on one CUDA card:
``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the checkout's root (see ``BENCHMARK.json``)."""
