"""flink_tpu_torch.scheduler: the latency controller, the skew rebalancer
and the elastic autoscaler (signals, policies, coordinator)."""

from flink_tpu_torch.scheduler.autoscaler import (
    AutoscalerCoordinator,
    empty_autoscaler_payload,
)
from flink_tpu_torch.scheduler.latency_controller import (
    LatencySpec,
    SuperbatchController,
    build_rung_ladder,
)
from flink_tpu_torch.scheduler.policy import (
    LearningPolicy,
    RescaleOutcome,
    ScalingDecision,
    ScalingPolicy,
    ThresholdPolicy,
    build_policy,
)
from flink_tpu_torch.scheduler.rebalancer import (
    RebalanceDecision,
    SkewRebalancer,
)
from flink_tpu_torch.scheduler.signals import (
    SignalAggregator,
    SignalEstimate,
    SignalSample,
    SignalWindow,
    extract_signals,
)

__all__ = [
    "AutoscalerCoordinator",
    "empty_autoscaler_payload",
    "LatencySpec",
    "SuperbatchController",
    "build_rung_ladder",
    "RebalanceDecision",
    "SkewRebalancer",
    "LearningPolicy",
    "RescaleOutcome",
    "ScalingDecision",
    "ScalingPolicy",
    "ThresholdPolicy",
    "build_policy",
    "SignalAggregator",
    "SignalEstimate",
    "SignalSample",
    "SignalWindow",
    "extract_signals",
]
