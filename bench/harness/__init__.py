"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``).

Everything that measures lives here, out of reach of the program: the
traffic generator, the window accounting, the FLOP and byte counts, the
table of peaks, the reading of the profiler trace, and the comparison
with the plain reference (``bench/reference``) that decides ``correct``.
Cells, configurations and their reference modules, traffic mixes,
limits and per-layer metrics are found by name (``spec.py``), so a new
one is new files and entries.
"""
