"""Control plane, milliseconds a step: the server's own host clock around
``schedule()`` plus each step's assembly (``control_plane_time``), its
change across the window over the steps dispatched in it."""


def read(run):
    d = run.window["delta"]
    if not d or d["steps"] <= 0:
        return None
    return 1e3 * d["control_plane_time"] / d["steps"]
