"""``host_busy_ms`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.host_busy_ms import read  # noqa: F401
