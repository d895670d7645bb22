"""Device, percent: the share of the traced stretch in which no kernel
ran on the card (1 - the union of kernel intervals / the stretch)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
