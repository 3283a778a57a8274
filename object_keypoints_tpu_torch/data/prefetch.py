"""Host -> device prefetching of host batches.

Counterpart of ``object_keypoints_tpu/data/prefetch.py::device_prefetch``,
which stands in for the reference's process-based loading (torch DataLoader
workers, scripts/train.py:143-149). On the card a worker thread draws the
next host batches, puts them in pinned memory and copies them with
``non_blocking`` copies on a side CUDA stream, recording an event after
each batch; the consumer's stream waits on that event before the batch is
used, so the copies overlap the step that runs. On the CPU it converts each
batch where it is. The JAX ``sharding`` argument has no counterpart until
the port trains on several devices.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import torch

_SENTINEL = object()


def _pinned(x) -> torch.Tensor:
    return torch.as_tensor(x).pin_memory()


def device_prefetch(batches: Iterable[dict], device="cuda", buffer_size: int = 2
                    ) -> Iterator[dict]:
    """Yield each host batch (a dict of arrays) as tensors on ``device``,
    staying up to ``buffer_size`` batches ahead on the card. A loader error
    is raised on the consumer's side."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    err: list = []
    stream = torch.cuda.Stream(device)

    def worker():
        try:
            with torch.cuda.stream(stream):
                for batch in batches:
                    out = {k: _pinned(v).to(device, non_blocking=True) for k, v in batch.items()}
                    ready = torch.cuda.Event()
                    ready.record(stream)
                    while not stop.is_set():
                        try:
                            q.put((out, ready), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
        except Exception as e:  # surface loader errors on the consumer side
            err.append(e)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=worker, name="device_prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            out, ready = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in out.values():
                t.record_stream(consumer)  # the side stream allocated it
            yield out
    finally:
        stop.set()
        while thread.is_alive():  # drain so the worker's last put returns
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
