"""``device_idle_share`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.device_idle_share import read  # noqa: F401
