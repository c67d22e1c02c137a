"""Launch and synchronisation counters that several threads may bump.

The kernels' wrappers count their launches in attributes of the wrapper
function (``fused_gp.gp_predict.launches``, ``gp_nll.launches`` and
``gp_nll.rows``, ``gp_nll_and_grad.launches``,
``blocked_gp._factor_invert.launches``), and the optimizer its host
synchronisations (``optimizer._lbfgs_segment.host_syncs``). With cell
sharding (``parallel.mesh``) the shards' threads launch at once, and a bare
``+= 1`` can lose an update; every such count goes through one lock here.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["bump", "launched"]

_LOCK = threading.Lock()


def bump(owner, name: str, by: int = 1) -> None:
    """Add ``by`` to the integer attribute ``name`` of ``owner``."""
    with _LOCK:
        setattr(owner, name, getattr(owner, name) + by)


def launched(wrapper, stream: int, rows: Optional[int] = None) -> None:
    """Count one kernel launch of ``wrapper``: ``wrapper.launches``,
    ``wrapper.streams[stream]`` (the CUDA stream it went to) and, where
    given, ``wrapper.rows[rows]`` (launches by their rows)."""
    with _LOCK:
        wrapper.launches += 1
        wrapper.streams[stream] += 1
        if rows is not None:
            wrapper.rows[rows] += 1
