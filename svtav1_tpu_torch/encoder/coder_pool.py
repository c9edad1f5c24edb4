"""The process's host threads for the flat path's host stage.

Two executors, made on first use and shared by every encoder of the
process (a capped re-encode's sub-encoders, ``VideoEncoder``'s key-frame
encoder, ``parallel.mesh``'s GOP threads): the coder pool, whose threads
run the native tile coder a frame each, as wide as the CPUs this process
may use less one for the thread that queues the device work; and one copy
thread, which waits for a batch's device work, copies its outputs to the
host and hands its frames to the coder pool.  No task of either waits on
a task of the coder pool (only the callers of ``host_finish`` do), so a
full pool cannot deadlock.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

_LOCK = threading.Lock()
_EXECUTORS = {}

# a forked child has none of its parent's threads: it makes its own
os.register_at_fork(after_in_child=_EXECUTORS.clear)


def width() -> int:
    """Coder threads: the CPUs this process may use, less one for the
    main thread, at least one."""
    return max(1, len(os.sched_getaffinity(0)) - 1)


def _executor(name: str, workers: int) -> ThreadPoolExecutor:
    with _LOCK:
        ex = _EXECUTORS.get(name)
        if ex is None:
            ex = _EXECUTORS[name] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"svt-{name}")
        return ex


def coders() -> ThreadPoolExecutor:
    """The coder pool (``width()`` threads, started as tasks come)."""
    return _executor("coder", width())


def copier() -> ThreadPoolExecutor:
    """The copy thread: batches' device-to-host copies, in the order
    they were queued."""
    return _executor("copy", 1)
