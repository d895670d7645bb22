"""``enqueue_ms`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.enqueue_ms import read  # noqa: F401
