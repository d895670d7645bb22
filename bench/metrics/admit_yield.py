"""Control plane, percent: admissions over admission attempts (the
scheduler's ``admitted`` / ``admit_tries``) in the window's steps."""
from bench.harness import spans


def read(run):
    w = spans.window(run)
    if w is None or w["admit_tries"].sum() <= 0:
        return None
    return 100.0 * float(w["admitted"].sum()) / float(w["admit_tries"].sum())
