"""Stall watchdog (copy of openibl_tpu/utils/watchdog.py, warnings only).

Wrap device-bound phases so a hung transfer, build or collective gets a
loud periodic warning instead of a silent hang:

    wd = Watchdog(warn_after=120)
    with wd.watch("gallery extraction"):
        feats = extract_features(...)
"""

import contextlib
import threading
import time


class Watchdog:
    def __init__(self, warn_after=120.0, log=print):
        self.warn_after = warn_after
        self.log = log

    @contextlib.contextmanager
    def watch(self, name):
        done = threading.Event()
        start = time.monotonic()

        def monitor():
            warned = 0
            while not done.wait(self.warn_after):
                warned += 1
                self.log(
                    f"[watchdog] phase '{name}' running for "
                    f"{time.monotonic() - start:.0f}s (warning #{warned}) — "
                    f"possible device stall"
                )

        t = threading.Thread(target=monitor, daemon=True)
        t.start()
        try:
            yield
        finally:
            done.set()
