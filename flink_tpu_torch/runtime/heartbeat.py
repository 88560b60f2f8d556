"""Bidirectional heartbeats with timeout-based failure detection.

Analogue of runtime/heartbeat/HeartbeatManagerImpl.java:49: a monitor tracks
last-seen times per target, a sender thread pings peers via a callable, and
targets silent for longer than the timeout are reported dead exactly once.

Shutdown is prompt and observable: the loop waits on an Event (not a bare
sleep), `stop()` joins the thread, and swallowed ping / on_dead callback
exceptions are COUNTED (`missed_pings` / `on_dead_errors`) instead of
silently passed. Note missedPings only moves for monitors registered WITH
a ping callable (active probing); the JM's TM liveness is receive-only,
so its gauge reads 0 by construction — partition drills there are
observed through restart/exception history, not this counter.

Counterpart of `flink_tpu/runtime/heartbeat.py`, copied.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional


class HeartbeatManager:
    def __init__(
        self,
        *,
        interval: float = 1.0,
        timeout: float = 5.0,
        on_dead: Optional[Callable[[str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.interval = interval
        self.timeout = timeout
        self.on_dead = on_dead
        # Injectable clock: timeout decisions compare THIS clock only, so
        # tests can drive virtual time instead of racing real sleeps
        # against suite-wide GIL stalls (long compilations in sibling
        # tests stretched 50 ms sleeps past sub-second timeouts).
        self._clock = clock
        self._targets: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # swallowed-exception accounting (CONC005: no silent swallows);
        # missed_pings moves only for ping-configured (actively probed)
        # monitors — see the module docstring
        self.missed_pings = 0
        self.on_dead_errors = 0
        self._thread = threading.Thread(target=self._loop, name="heartbeat",
                                        daemon=True)
        self._thread.start()

    def monitor(self, target_id: str, ping: Optional[Callable[[], None]] = None) -> None:
        """Track a target; `ping` (optional) is invoked every interval — an
        exception or silence past the timeout marks the target dead."""
        with self._lock:
            self._targets[target_id] = {"last": self._clock(), "ping": ping, "dead": False}

    def unmonitor(self, target_id: str) -> None:
        with self._lock:
            self._targets.pop(target_id, None)

    def receive_heartbeat(self, target_id: str) -> None:
        with self._lock:
            t = self._targets.get(target_id)
            if t is not None:
                t["last"] = self._clock()
                t["dead"] = False

    def is_alive(self, target_id: str) -> bool:
        with self._lock:
            t = self._targets.get(target_id)
            return t is not None and not t["dead"]

    def check_now(self) -> None:
        """Run one ping/timeout sweep at the injected clock's current time.

        The loop thread calls this every interval; tests with a virtual
        clock call it directly so detection is deterministic instead of a
        race between real sleeps and suite-wide scheduler latency."""
        now = self._clock()
        with self._lock:
            items = list(self._targets.items())
        for tid, t in items:
            if t["dead"]:
                continue
            ping = t["ping"]
            if ping is not None:
                try:
                    ping()
                    self.receive_heartbeat(tid)
                    continue
                except Exception:
                    # treat like silence (timeout decides), but COUNT
                    # it: consecutive missed pings are the early
                    # warning a partition drill watches for
                    self.missed_pings += 1
            if now - t["last"] > self.timeout:
                with self._lock:
                    if t["dead"]:
                        continue
                    t["dead"] = True
                if self.on_dead is not None:
                    try:
                        self.on_dead(tid)
                    except Exception:
                        # a throwing death callback must not kill the
                        # detector for every OTHER target — counted,
                        # never silently dropped
                        self.on_dead_errors += 1

    def _loop(self) -> None:
        while True:
            self.check_now()
            # Event.wait, not time.sleep: stop() must not block shutdown
            # for up to a full interval (leaked beat loops kept dialing
            # dead JMs in test stacks)
            if self._stop.wait(self.interval):
                return

    def stop(self) -> None:
        self._stop.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)
