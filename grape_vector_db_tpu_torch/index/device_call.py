"""DeviceCalls — the one contract of an index's device search call, shared
by the flat and IVF families so that every kind records the same spans and
counters: the index lock (``_lock``) with the seconds a search waited for it
(``lock_wait_s``), the call's ``DeviceWindow`` (``_window``, on CUDA), the
spans ``index.launch`` and ``index.readback``, the always-on ``counters()``,
and the query prologue.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from grape_vector_db_tpu_torch.errors import DimensionMismatchError
from grape_vector_db_tpu_torch.utils.buckets import next_bucket, pad_rows
from grape_vector_db_tpu_torch.utils.tracing import DeviceWindow, trace_span

__all__ = ["DeviceCalls"]


class DeviceCalls:
    """Mixin over ``VectorIndex``: needs ``device``, ``_dim`` and ``__len__``,
    and ``_init_device_calls()`` from the index's ``__init__``."""

    def _init_device_calls(self) -> None:
        self._lock = threading.RLock()
        self.lock_wait_s = 0.0
        self._window: Optional[DeviceWindow] = None   # made at a CUDA index's first search

    @contextlib.contextmanager
    def _search_lock(self):
        """The index lock for a search, its wait counted in ``lock_wait_s``."""
        if not self._lock.acquire(blocking=False):
            t0 = time.perf_counter()
            self._lock.acquire()
            self.lock_wait_s += time.perf_counter() - t0
        try:
            yield
        finally:
            self._lock.release()

    def _padded_queries(self, queries: np.ndarray) -> Tuple[Optional[np.ndarray], int]:
        """(the f32 queries padded to a bucket of 8, the true count B), with
        None in place of the batch where there is nothing to search. The
        padded batch is what the kernel routing reads (as in the reference),
        so every kind keeps the same bucket."""
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError("queries must be [B, dim]")
        if queries.shape[1] != self._dim:
            raise DimensionMismatchError(self._dim, queries.shape[1])
        b = queries.shape[0]
        if b == 0 or len(self) == 0:
            return None, b
        return pad_rows(queries, next_bucket(b, base=8)), b

    def _device_call(self, launch: Callable, queries: np.ndarray,
                     mask: Optional[np.ndarray] = None,
                     rows: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """``launch(q, m)`` over the queries (f32) and the mask (bool; None
        stays None) uploaded to the device, under the index lock, and the
        first ``rows`` rows (all where None) of its two result tensors read
        back as numpy. ``index.launch`` spans the enqueueing, ``index.readback``
        the host blocked on the device and the copy back; the window runs
        from before the upload to after the last launch."""
        with self._search_lock():
            if self._window is None and self.device.type == "cuda":
                self._window = DeviceWindow(self.device)
            window = self._window
            if window is not None:
                window.open()
            q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(self.device)
            m = None if mask is None else torch.from_numpy(
                np.asarray(mask, dtype=bool)).to(self.device)
            with trace_span("index.launch"):
                vals, idxs = launch(q, m)
            if window is not None:
                window.close()
            with trace_span("index.readback"):
                if rows is not None:
                    vals, idxs = vals[:rows], idxs[:rows]
                out = vals.cpu().numpy(), idxs.cpu().numpy()
            if window is not None:
                window.settle()
            return out

    def counters(self) -> Dict[str, float]:
        """The index's always-on counters, exported on /metrics: the seconds
        searches waited for its lock, and the device milliseconds of their
        calls (CUDA only)."""
        return {"index_lock_wait_seconds_total": self.lock_wait_s,
                "device_time_ms_total": self._window.ms_total if self._window else 0.0}
