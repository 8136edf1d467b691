"""Filename patterns and memoisation helpers.

Port of ``driftscan_tpu/util/util.py`` (plain Python, unchanged in
behaviour).
"""

from __future__ import annotations

import functools
import math
import queue
import threading


def intpattern(n: int) -> str:
    """printf pattern wide enough for integers up to ``n``, always signed."""
    width = int(math.ceil(math.log10(n + 1))) + 1
    return f"%+0{width}d"


def natpattern(n: int) -> str:
    """printf pattern wide enough for naturals up to ``n`` (zero padded)."""
    width = int(math.ceil(math.log10(n + 1)))
    return f"%0{width}d"


def cache_last(func):
    """Memoise only the most recent call of ``func``.

    Useful for the per-m file accessors which are typically called several
    times in a row with the same arguments.
    """
    state = {"args": None, "kwargs": None, "set": False, "ret": None}

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not state["set"] or args != state["args"] or kwargs != state["kwargs"]:
            state["ret"] = func(*args, **kwargs)
            state["args"] = args
            state["kwargs"] = kwargs
            state["set"] = True
        return state["ret"]

    return wrapper


class BackgroundWriter:
    """Single worker thread draining queued write jobs.

    Lets product generation overlap file writes with device compute: the
    main thread enqueues ``(fn, args)`` jobs and keeps dispatching device
    work while the worker writes.  One worker only, so HDF5 access stays
    single-threaded.  ``close()`` drains the queue, joins the worker and
    re-raises the first job exception: a failed write fails the stage.
    The queue is bounded, so host memory holds at most a few chunks of
    products at a time.
    """

    def __init__(self, maxsize: int = 4):
        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            fn, args, kwargs = job
            if self._err is None:
                try:
                    fn(*args, **kwargs)
                except BaseException as exc:  # re-raised in close()
                    self._err = exc

    def submit(self, fn, *args, **kwargs):
        if self._err is not None:
            # fail fast: no point queueing behind a dead stage
            self.close()
        self._q.put((fn, args, kwargs))

    def close(self):
        """Drain, join and re-raise the first worker exception."""
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
