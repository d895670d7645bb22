"""Cache manager, percent: KV blocks found resident at admission over
blocks looked up (``BlockManager.n_hits`` / ``n_lookups``), their
changes across the window."""


def read(run):
    d = run.window["delta"]
    if not d or d["lookups"] <= 0:
        return None
    return 100.0 * d["hits"] / d["lookups"]
