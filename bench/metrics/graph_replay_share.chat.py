"""``graph_replay_share`` in the chat cell, where it moves ``itl_p95_s``."""
from bench.metrics.graph_replay_share import read  # noqa: F401
