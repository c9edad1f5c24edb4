"""Seconds of the process's kernel and coder builds or loads before
and in the traced run: the program's setup.build spans (nvcc, gcc, or a
built library's load), recorded whatever the tracing flag says."""

from ._recorder import recorder


def read(run):
    tr = recorder()
    if run.trace is None or tr is None:
        return None
    spans = [r for r in tr.records()
             if r.kind == "host" and r.name == "setup.build"]
    return sum(r.end_ns - r.start_ns for r in spans) / 1e9 if spans \
        else None
