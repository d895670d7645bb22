"""``control_plane_ms`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.control_plane_ms import read  # noqa: F401
