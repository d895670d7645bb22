"""``admit_yield`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.admit_yield import read  # noqa: F401
