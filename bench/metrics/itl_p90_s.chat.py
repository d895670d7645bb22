"""``itl_p90_s`` in the chat cell, read in the traced run: there it
lies between two step-time levels (``itl_p95_s.py``), so it says which
share of the gaps the steps with a long prefill chunk take."""
from bench.metrics.itl_p90_s import read  # noqa: F401
