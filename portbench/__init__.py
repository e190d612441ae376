"""The benchmark of covins_tpu_torch on one H100 (`BENCHMARK.json`)."""
