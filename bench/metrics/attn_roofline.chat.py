"""``attn_roofline`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.attn_roofline import read  # noqa: F401
