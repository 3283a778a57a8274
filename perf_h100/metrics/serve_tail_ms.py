"""The 95th percentile of every call's latency in the traced run's window,
ms: host clock from submit until the call's decoded objects are on the host.
(A per-layer metric, one a cell (``serve_tail_ms.<cell>``): across runs of
one code it swings more than half of any end-to-end bound it could hold;
PERF.md section 2.)"""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
