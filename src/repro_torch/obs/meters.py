"""Process-local metric registry: counters, gauges, and the ambient stack.

The port of the registry half of ``repro.obs.meters``.  A :class:`Meters`
is a flat ``name -> number`` map with two write verbs:

* ``inc(name, v)``  -- counter semantics;
* ``set(name, v)``  -- gauge semantics, idempotent (hooks that run every
  step, such as ``WireExchange`` gauging its static ``BucketLayout``).

:func:`env_info` is the environment stamp of every RunReport.

Instrumented library code never takes a registry argument -- it records
into the *ambient* registry, installed with :func:`using_meters`::

    m = Meters()
    with using_meters(m):
        runner.run(...)          # WireExchange hooks land in m

With no ambient registry every hook is a no-op (``current_meters()``
returns ``None``).  Wire gauges: ``wire/bytes_per_hop``, ``wire/hops``,
``wire/collectives_per_step`` (calls of the ``pp`` seam per step) and the
counter ``wire/exchanges``.
"""
from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import threading
from typing import Dict, Iterator, List, Optional


class Meters:
    """Flat name -> number registry (thread-safe; see module docstring)."""

    def __init__(self) -> None:
        self._values: Dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1) -> None:
        """Counter write: add ``value`` to ``name`` (0 if absent)."""
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        """Gauge write: assign ``value`` (idempotent)."""
        with self._lock:
            self._values[name] = value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._values.get(name, default)

    def as_dict(self) -> Dict[str, float]:
        """Sorted plain-dict snapshot (JSON-ready)."""
        with self._lock:
            return {k: self._values[k] for k in sorted(self._values)}

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Meters({self.as_dict()!r})"


# --------------------------------------------------------------------------
# Ambient registry stack
# --------------------------------------------------------------------------

_STACK: List[Meters] = []
_STACK_LOCK = threading.Lock()


def current_meters() -> Optional[Meters]:
    """The innermost registry installed by :func:`using_meters`, or None."""
    with _STACK_LOCK:
        return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def using_meters(meters: Meters) -> Iterator[Meters]:
    """Install ``meters`` as the ambient registry for the with-block."""
    with _STACK_LOCK:
        _STACK.append(meters)
    try:
        yield meters
    finally:
        with _STACK_LOCK:
            _STACK.remove(meters)


# --------------------------------------------------------------------------
# Environment stamp
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _smi_power_limit(index: int) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None if r.returncode == 0 else None


def env_info(device=None) -> Dict[str, object]:
    """The environment stamp of a RunReport: enough to attribute a number
    to a machine -- torch and its CUDA runtime, the run's device (a card's
    name and power limit; a card may be capped below its maximum and then
    runs slower under load) and the host's CPU count."""
    import torch
    device = torch.device(device if device is not None else "cpu")
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device_type": device.type, "cpu_count": os.cpu_count() or 1}
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        info.update(device_kind=torch.cuda.get_device_name(index),
                    device_count=torch.cuda.device_count(),
                    power_limit=_smi_power_limit(index))
    return info
