"""The benchmark of putting_dune_torch (see BENCHMARK.json at the repo root)."""
