"""flink_tpu_torch.chaos: deterministic fault injection and the scenario drills.

Counterpart of `flink_tpu/chaos/`. :mod:`flink_tpu_torch.chaos.plan`
(re-exported here) holds the seeded FaultPlan and the module-level HOOK
the runtime's seams check; it imports nothing of the runtime, so every
layer can import it. :mod:`flink_tpu_torch.chaos.scenarios` (import it
explicitly) runs real jobs under injected faults and holds each recovery
to the undisturbed run's rows; it imports the runtime.
"""

from flink_tpu_torch.chaos.plan import (  # noqa: F401
    INJECTED_MARKER,
    FaultPlan,
    FaultRule,
    InjectedCrash,
    InjectedFault,
    active_plan,
    install_plan,
    uninstall_plan,
)
