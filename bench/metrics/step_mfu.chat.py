"""``step_mfu`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.step_mfu import read  # noqa: F401
