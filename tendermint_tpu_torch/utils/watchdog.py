"""CircuitBreaker: closed / open / half-open with a cooldown.

The port's copy of the breaker in the JAX package's ``utils/watchdog.py``,
the one piece of that module the mesh router needs: one breaker per
device of a ``parallel.topology.DeviceTopology``. Failures trip it open;
after ``cooldown_s`` exactly one caller gets the half-open probe; its
success closes the breaker, its failure re-opens it with a new cooldown.

Not copied: the ``Watchdog`` supervisor, ``force_open``, the process-wide
registry of breakers and ``set_breaker_defaults``, and the trace instants
(the counters in ``stats`` carry the same facts).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

# Defaults for breakers built without explicit knobs, read at each
# transition (the JAX package's config defaults).
_DEFAULT_FAILURE_THRESHOLD = 3
_DEFAULT_COOLDOWN_S = 30.0

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker.

    ``allow()`` is the gate callers check before the protected path:
    closed -> True; open -> False until ``cooldown_s`` has elapsed, then
    exactly ONE caller gets True (the half-open probe) while everyone
    else keeps getting False until the probe reports back via
    ``record_success``/``record_failure`` (or hands its token back with
    ``release_probe``)."""

    def __init__(self, name: str, failure_threshold: Optional[int] = None, cooldown_s: Optional[float] = None):
        self.name = name
        self._failure_threshold = failure_threshold
        self._cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0  # consecutive failures while closed
        self._opened_at = 0.0
        self.trips = 0
        self.recoveries = 0
        self.probes = 0

    @property
    def failure_threshold(self) -> int:
        return self._failure_threshold if self._failure_threshold is not None else _DEFAULT_FAILURE_THRESHOLD

    @property
    def cooldown_s(self) -> float:
        return self._cooldown_s if self._cooldown_s is not None else _DEFAULT_COOLDOWN_S

    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
                self.probes += 1
                return True
            return False  # HALF_OPEN: a probe is already in flight

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == CLOSED:
                return
            self._state = CLOSED
            self.recoveries += 1

    def release_probe(self) -> None:
        """Return an unused half-open probe token: the caller passed
        ``allow()`` but never ran the protected path, so there is no
        verdict to record. Back to OPEN with the original trip time (the
        cooldown has elapsed, so the next ``allow()`` may probe at once).
        No-op unless half-open; without it an unexercised probe would
        latch the breaker HALF_OPEN for good."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = OPEN

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # a failed probe: straight back to open, a new cooldown
                self._state = OPEN
                self._opened_at = time.monotonic()
                self.trips += 1
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._failures = 0
                self.trips += 1

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self._state,
                "state_code": _STATE_CODE[self._state],
                "trips": self.trips,
                "recoveries": self.recoveries,
                "probes": self.probes,
            }
