"""Deterministic fault injection: the chaos plane's core.

Counterpart of `flink_tpu/chaos/plan.py`, copied: for the same rules and
seed a plan fires the same sequence over the same calls.

A :class:`FaultPlan` holds rules (scope + fault kind + trigger) and is
installed as ONE module-level callable (:data:`HOOK`). The runtime's seams
check it with a single ``is None`` comparison per call, so a disabled chaos
plane costs one attribute load on the hot path and nothing else.

Seams of the port (each passes its scope + a site label):

=============  =========================================================
scope          where the hook fires
=============  =========================================================
``storage``    checkpoint/storage.py save/load (site ``save:<id>`` /
               ``load:<handle>``); state/cold_tier.py reads (site
               ``cold-tier:<what>``)
``device``     runtime/executor.py window-step and fused-chain batches,
               runtime/device_join_operator.py ingests (site op uid),
               before anything of the batch is staged or launched
=============  =========================================================

The ``transport``, ``rpc``, ``dataplane`` and ``heartbeat`` scopes are
the cluster's seams, as the JAX package's: security/transport.py's
handshakes, runtime/rpc.py's calls, runtime/dataplane.py's sends and the
JobManager's heartbeat intake (runtime/cluster.py); the cluster scenarios
of chaos/scenarios.py drive them.

Faults: ``error`` raises :class:`InjectedFault` (a ``ConnectionError``,
so every transient-fault path treats it like a real peer failure);
``crash`` raises :class:`InjectedCrash` (same, but hardening layers must
NOT absorb it: it models a process death, not a blip); ``delay`` sleeps;
``drop`` and ``torn`` return a directive the seam implements (drop a
frame, tear a checkpoint artifact); ``partition`` is ``drop`` that
defaults to unlimited fires.

Every injected fault is labeled with :data:`INJECTED_MARKER` so failures
it causes are attributed ``injected: true`` in the job's ExceptionHistory
(metrics/checkpoint_stats.py).

This module imports nothing of the package but, lazily, the config
(`chaos.*`), so the seams of every layer can import it.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: substring stamped into every injected fault's message: ExceptionHistory
#: derives its `injected: true` attribution from it (the distributed path
#: ships failures as strings, so the label must survive repr()).
INJECTED_MARKER = "[chaos-injected"

_VALID_SCOPES = ("transport", "rpc", "dataplane", "storage", "device",
                 "heartbeat")
_VALID_FAULTS = ("error", "crash", "delay", "drop", "torn", "partition")

#: sentinel distinguishing "max_fires omitted" from an explicit value: the
#: partition default widens to unlimited fires, but an operator's explicit
#: max_fires=1 must stay exactly one dropped call
_UNSET_MAX_FIRES = object()


class InjectedFault(ConnectionError):
    """A chaos-injected transient fault. Subclasses ConnectionError so the
    seams' existing `except OSError` transient-fault paths (rpc retry,
    dataplane reconnect) treat it exactly like a real peer failure."""

    def __init__(self, label: str):
        super().__init__(f"{INJECTED_MARKER}:{label}] injected fault")
        self.label = label


class InjectedCrash(InjectedFault):
    """A chaos-injected hard failure (process-death model): hardening
    layers re-raise it instead of absorbing it, so it always reaches the
    failure-detection/restart machinery."""


@dataclasses.dataclass
class FaultRule:
    """One declarative injection rule.

    Trigger semantics: a call at (scope, site) matches when the rule's
    scope equals the call's scope and `match` is a substring of the site
    ("" matches everything). The rule fires on matching calls number
    `nth`, `nth`+1, ... (1-based; 0 = from the first), each with
    `probability`, inside `window_s` (seconds since plan install; None =
    always), at most `max_fires` times (None = unlimited)."""

    scope: str
    fault: str
    match: str = ""
    nth: int = 0
    probability: float = 1.0
    # default: 1 fire — except partition, which models an outage and
    # defaults to unlimited; an EXPLICIT max_fires always wins
    max_fires: Any = _UNSET_MAX_FIRES
    delay_s: float = 0.0
    window_s: Optional[Tuple[float, float]] = None
    label: str = ""

    def __post_init__(self):
        if self.scope not in _VALID_SCOPES:
            raise ValueError(f"unknown chaos scope {self.scope!r} "
                             f"(valid: {', '.join(_VALID_SCOPES)})")
        if self.fault not in _VALID_FAULTS:
            raise ValueError(f"unknown chaos fault {self.fault!r} "
                             f"(valid: {', '.join(_VALID_FAULTS)})")
        if self.max_fires is _UNSET_MAX_FIRES:
            self.max_fires = None if self.fault == "partition" else 1
        if not self.label:
            self.label = f"{self.scope}:{self.fault}:{self.match or '*'}"


class FaultPlan:
    """A seeded set of FaultRules with thread-safe trigger accounting.

    `act(scope, site)` is the single entry point the seams call (via
    :data:`HOOK`): it returns None (no fault — the overwhelmingly common
    case), returns a directive string ("drop" / "torn") the seam
    implements, sleeps for delay faults, or raises InjectedFault/
    InjectedCrash for error/crash faults. All randomness comes from the
    seeded RNG, so a plan over a deterministic workload replays the same
    fault sequence run after run."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._matches = [0] * len(self.rules)
        self._fires = [0] * len(self.rules)
        self.fired: List[Tuple[str, str, str]] = []   # (label, scope, site)

    # -- the seam entry point ---------------------------------------------
    def act(self, scope: str, site: str) -> Optional[str]:
        directive = None
        delay = 0.0
        error: Optional[InjectedFault] = None
        with self._lock:
            now = self._clock() - self._t0
            for i, rule in enumerate(self.rules):
                if rule.scope != scope or rule.match not in site:
                    continue
                self._matches[i] += 1
                if rule.nth and self._matches[i] < rule.nth:
                    continue
                if rule.max_fires is not None and \
                        self._fires[i] >= rule.max_fires:
                    continue
                if rule.window_s is not None and not (
                        rule.window_s[0] <= now <= rule.window_s[1]):
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                self._fires[i] += 1
                self.fired.append((rule.label, scope, site))
                if rule.fault == "delay":
                    delay = max(delay, rule.delay_s)
                elif rule.fault == "crash":
                    error = InjectedCrash(rule.label)
                elif rule.fault == "error":
                    if error is None:       # crash outranks error
                        error = InjectedFault(rule.label)
                elif rule.fault == "torn":
                    directive = "torn"
                else:                       # drop / partition
                    directive = "drop"
        # side effects OUTSIDE the lock: a sleeping/raising rule must not
        # serialize every other seam's no-fault check behind it
        if delay > 0.0:
            time.sleep(delay)
        if error is not None:
            raise error
        return directive

    # -- accounting --------------------------------------------------------
    @property
    def total_fired(self) -> int:
        with self._lock:
            return len(self.fired)

    def report(self) -> Dict[str, Any]:
        """Per-rule match/fire counts + the fired-event log (label, scope,
        site) — what a scenario asserts its injection actually happened."""
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [
                    {"label": r.label, "scope": r.scope, "fault": r.fault,
                     "matches": self._matches[i], "fires": self._fires[i]}
                    for i, r in enumerate(self.rules)
                ],
                "fired": list(self.fired),
            }

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_rules(rule_dicts: List[dict], seed: int = 0) -> "FaultPlan":
        rules = []
        for d in rule_dicts:
            d = dict(d)
            if "window_s" in d and d["window_s"] is not None:
                d["window_s"] = tuple(d["window_s"])
            rules.append(FaultRule(**d))
        return FaultPlan(rules, seed=seed)

    @staticmethod
    def from_config(config) -> Optional["FaultPlan"]:
        """Build from the `chaos.*` config group (None when disabled or no
        rules). `chaos.rules` is a JSON list of FaultRule field dicts."""
        from flink_tpu_torch.config import ChaosOptions

        if not config.get(ChaosOptions.ENABLED):
            return None
        raw = config.get(ChaosOptions.RULES) or ""
        rule_dicts = json.loads(raw) if raw.strip() else []
        return FaultPlan.from_rules(rule_dicts,
                                    seed=config.get(ChaosOptions.SEED))


# ---------------------------------------------------------------------------
# the module-level hook the seams check (None = chaos off, zero work)
# ---------------------------------------------------------------------------

#: the installed plan's `act`, or None. Seams read this ONCE per call:
#: `hook = plan_module.HOOK; if hook is not None: hook(scope, site)`.
HOOK: Optional[Callable[[str, str], Optional[str]]] = None

_installed: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Install `plan` process-wide (exactly one plan at a time: stacked
    plans would make nth-counting meaningless)."""
    global HOOK, _installed
    with _install_lock:
        if _installed is not None:
            raise RuntimeError("a FaultPlan is already installed — "
                               "uninstall_plan() first")
        _installed = plan
        HOOK = plan.act
    return plan


def uninstall_plan() -> Optional[FaultPlan]:
    global HOOK, _installed
    with _install_lock:
        plan, _installed = _installed, None
        HOOK = None
    return plan


def active_plan() -> Optional[FaultPlan]:
    return _installed
