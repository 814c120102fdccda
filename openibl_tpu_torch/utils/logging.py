"""Run-log capture: mirror interpreter stdout into a durable log file (copy
of openibl_tpu/utils/logging.py).

An ``io.TextIOBase`` fan-out stream over a list of sinks (the console and
the log file).
"""

import atexit
import io
import os
from contextlib import contextmanager


class FanoutStream(io.TextIOBase):
    """Text stream that forwards every write to all of its sinks.

    Sinks passed as ``owned`` are additionally fsync'd on flush (so the log
    file survives a hard kill mid-run) and closed by :meth:`close`; borrowed
    sinks (e.g. the real console) are left untouched.
    """

    def __init__(self, sinks, owned=()):
        super().__init__()
        self._sinks = list(sinks) + list(owned)
        self._owned = list(owned)

    def writable(self):
        return True

    def write(self, text):
        for sink in self._sinks:
            sink.write(text)
        return len(text)

    def flush(self):
        for sink in self._sinks:
            sink.flush()
        for sink in self._owned:
            try:
                os.fsync(sink.fileno())
            except (OSError, ValueError):
                pass  # sink has no file descriptor / already closed

    def close(self):
        if self.closed:
            return
        self.flush()
        for sink in self._owned:
            sink.close()
        self._sinks = [s for s in self._sinks if s not in self._owned]
        self._owned = []
        atexit.unregister(self.close)  # don't accumulate closed streams
        super().close()


def Logger(fpath=None, console=None):
    """Build a stdout-mirroring stream: ``sys.stdout = Logger(path)``.

    Writes go to the current console and, when ``fpath`` is given, to a
    line-buffered log file created (directories included) on the spot. The
    file is registered for closure at interpreter exit, so plain assignment
    over ``sys.stdout`` cannot leak it.
    """
    import sys

    sinks = [console if console is not None else sys.stdout]
    owned = []
    if fpath is not None:
        parent = os.path.dirname(fpath)
        if parent:
            os.makedirs(parent, exist_ok=True)
        owned.append(open(fpath, "w", buffering=1))
    stream = FanoutStream(sinks, owned=owned)
    atexit.register(stream.close)
    return stream



@contextmanager
def tee_stdout(fpath):
    """Scoped variant: mirror stdout into ``fpath`` for the block's duration."""
    import sys

    stream = Logger(fpath)
    prev, sys.stdout = sys.stdout, stream
    try:
        yield stream
    finally:
        sys.stdout = prev
        stream.close()
