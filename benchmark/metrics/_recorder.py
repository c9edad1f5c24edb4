"""The program's own spans and counters (``svtav1_tpu_torch/utils/
trace.py``) in a traced run, for the readers beside this file.  Each
returns nothing where there is nothing to read: an untraced run, a
program without the recorder, or no record of the name."""


def recorder():
    """The program's recorder module, or None where the program has
    none."""
    try:
        from svtav1_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def window(run, kind: str, name: str) -> list:
    """The records of one kind ("host", "device" or "count") and name
    stamped inside the window (start on the host clock in [t0, t_end])."""
    tr = recorder()
    if run.trace is None or tr is None:
        return []
    t0, t1 = run.window.t0 * 1e9, run.window.t_end * 1e9
    return [r for r in tr.records()
            if r.kind == kind and r.name == name and t0 <= r.start_ns <= t1]


def mean_ms(run, name: str, kind: str = "host"):
    """The mean length in ms of the window's spans of one name."""
    recs = window(run, kind, name)
    if not recs:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / len(recs) / 1e6


def total(run, name: str):
    """The sum of the window's samples of one counter."""
    recs = window(run, "count", name)
    return sum(r.n for r in recs) if recs else None


def per_call_ms(run, name: str):
    """The window's spans of one name summed, in ms, over the number of
    device_encode calls (its enc.stage spans): for the spans a call makes
    once a plane."""
    recs = window(run, "host", name)
    calls = len(window(run, "host", "enc.stage"))
    if not recs or not calls:
        return None
    return sum(r.end_ns - r.start_ns for r in recs) / calls / 1e6
