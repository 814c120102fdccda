"""How late the load generator sent requests: the 95th percentile of each
request's send time (the client thread's call into ``query``) minus its due
time, in ms, on the harness's clock."""

import numpy as np


def read(run):
    info = run.info
    lag = np.asarray(info["sent"]) - np.asarray(info["due"])
    lag = lag[np.isfinite(lag)]
    if not len(lag):
        return None
    return float(1e3 * np.sort(lag)[max(0, int(np.ceil(0.95 * len(lag))) - 1)])
