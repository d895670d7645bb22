"""``admission_ms`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.admission_ms import read  # noqa: F401
