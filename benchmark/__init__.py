"""The benchmark of the PyTorch/CUDA port (opencv_dlco_tpu_torch).

See BENCHMARK.json at the repository's root and PERF.md. ``run.py`` runs
one cell; ``harness/`` finds the cell's files by name, records spans and
reduces the trace; ``entries/`` drive the program; ``inputs/`` make the
inputs from the seed; ``reference/`` is the plain reference; ``counts/``
count operations and bytes from shapes; ``metrics/`` are the per-layer
readers; ``tools/`` hold the readings that set the check's limits.
"""
