"""Chaos scenario drills: real jobs under injected faults.

Counterpart of the in-process half of `flink_tpu/chaos/scenarios.py`. Each
named scenario runs a deterministic keyed-window job twice on the
MiniCluster, once undisturbed (the oracle) and once with a seeded FaultPlan
installed, and checks (1) exactly-once result parity between the two runs,
(2) the expected recovery shape (restarts, tolerated checkpoint failures, a
degraded mesh), and (3) that injected faults which caused failures are
attributed ``injected: true`` in the job's ExceptionHistory. The workloads,
rules and checks are the JAX package's; every scenario takes `device=`
(the card unless the caller asks for the CPU) and the mesh scenarios
`shards=`: the mesh is that many shards of the job's device
(`parallel/mesh.py::visible_devices` replaced for the run), never the
number of cards.

The JAX package's four cluster scenarios (rpc-flap, dataplane-blip,
tm-crash-during-rescale, heartbeat-partition) need the distributed
JobManager and TaskManagers, which the port does not carry yet: asking for
one raises, naming its ROADMAP.md item.

This module imports the runtime: import it explicitly, never from
`flink_tpu_torch.chaos`'s package ``__init__``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from flink_tpu_torch.chaos.plan import FaultPlan, active_plan, uninstall_plan
from flink_tpu_torch.testing.harness import fault_injection
from flink_tpu_torch.utils import deferred
from flink_tpu_torch.utils.device import resolve_device

#: the JAX package's scenarios that need the distributed cluster
CLUSTER_SCENARIOS = ("rpc-flap", "dataplane-blip", "tm-crash-during-rescale",
                     "heartbeat-partition")


@contextlib.contextmanager
def mesh_of(device, shards: int):
    """Jobs in the block see `shards` shards of `device` as their mesh's
    devices: `parallel/mesh.py::visible_devices` replaced, restored after."""
    from flink_tpu_torch.parallel import mesh as mesh_lib

    real = mesh_lib.visible_devices
    dev = torch.device(device)
    mesh_lib.visible_devices = lambda _device: [dev] * shards
    try:
        yield
    finally:
        mesh_lib.visible_devices = real


def _mini_config(*, batch: int, key_capacity: int, chk_dir: Optional[str],
                 interval_ms: int = 1, max_retained: int = 50, tolerable: int = 0,
                 extra_config: Optional[dict] = None):
    from flink_tpu_torch.config import (
        CheckpointingOptions,
        Configuration,
        ExecutionOptions,
        RestartOptions,
    )

    config = Configuration()
    config.set(ExecutionOptions.BATCH_SIZE, batch)
    config.set(ExecutionOptions.KEY_CAPACITY, key_capacity)
    config.set(RestartOptions.INITIAL_BACKOFF_MS, 1)
    if chk_dir is not None:
        config.set(CheckpointingOptions.INTERVAL_MS, interval_ms)
        config.set(CheckpointingOptions.DIRECTORY, chk_dir)
        config.set(CheckpointingOptions.MAX_RETAINED, max_retained)
        config.set(CheckpointingOptions.TOLERABLE_FAILED_CHECKPOINTS, tolerable)
    for opt, val in (extra_config or {}).items():
        config.set(opt, val)
    return config


def _execute(env, name: str, timeout_s: float):
    client = env.execute_async(name)
    client.wait(timeout_s)
    return client


# ---------------------------------------------------------------------------
# shared workload: MiniCluster keyed tumbling count job
# ---------------------------------------------------------------------------

def _run_mini_count_job(name: str, *, device, records: int = 2600, batch: int = 200,
                        chk_dir: Optional[str] = None, interval_ms: int = 1,
                        tolerable: int = 0, max_retained: int = 50,
                        fail_at_ts: Optional[int] = None,
                        timeout_s: float = 120.0,
                        extra_config: Optional[dict] = None):
    """One keyed tumbling-count DataStream job on the in-process path.
    Returns (client, sorted sink rows). `fail_at_ts` installs a one-shot
    REAL failure (a map raising at an event-time threshold, deterministic
    in event time, used to force the restart that exercises restore)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.utils.arrays import obj_array

    # ring capacity 768, the JAX scenarios' own
    config = _mini_config(batch=batch, key_capacity=768, chk_dir=chk_dir,
                          interval_ms=interval_ms, max_retained=max_retained,
                          tolerable=tolerable, extra_config=extra_config)
    state = {"failed": False}

    def maybe_fail(x):
        if fail_at_ts is not None and not state["failed"] and x[2] >= fail_at_ts:
            state["failed"] = True
            raise RuntimeError(f"forced failure at ts {x[2]}")
        return x

    def gen(idx: np.ndarray) -> Batch:
        values = [(int(i % 7), 1.0, int(i * 10)) for i in idx]
        return Batch(obj_array(values), (idx * 10).astype(np.int64))

    env = StreamExecutionEnvironment(config, device=device)
    stream = env.from_source(
        DataGeneratorSource(gen, count=records, num_splits=8),
        watermark_strategy=WatermarkStrategy.for_monotonous_timestamps(),
    )
    sink = CollectSink()
    (stream.map(maybe_fail)
           .key_by(lambda x: x[0])
           .window(TumblingEventTimeWindows.of(1000)).count()
           .sink_to(sink))
    client = _execute(env, name, timeout_s)
    return client, sorted((int(k), int(n)) for k, n in sink.results)


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def _result(name: str, path: str, plan: Optional[FaultPlan],
            problems: List[str], *, parity: Optional[bool] = None,
            restarts: int = 0, recovery_ms: Optional[float] = None,
            attributed: Optional[bool] = None,
            skipped: bool = False,
            doctor: Optional[str] = None) -> Dict[str, Any]:
    return {
        "name": name,
        "path": path,
        "passed": not problems,
        "detail": "; ".join(problems),
        "parity": bool(parity) if parity is not None else False,
        "restarts": int(restarts),
        "recovery_ms": recovery_ms,
        "injected_fired": plan.total_fired if plan is not None else 0,
        "attributed": attributed,
        # a scenario whose precondition the run cannot meet (a mesh of one
        # shard): consumers must be able to tell this from a pass
        "skipped": bool(skipped),
        # the job doctor's post-run verdict, for the scenarios that check
        # live diagnosis of the injected fault family
        "doctor": doctor,
    }


def _check(problems: List[str], ok: bool, what: str) -> bool:
    if not ok:
        problems.append(what)
    return ok


def _doctor_checks(problems: List[str], client, t0_ms: float,
                   expected_family: str = "recovery-restart") -> str:
    """The doctor's TOP diagnosis names the injected fault family, and at
    least one watchdog ``health.*`` span landed inside the fault window
    [t0_ms, now]. Returns the verdict for the result dict."""
    doc = client.doctor_report()
    fams = [d["family"] for d in doc.get("diagnoses", [])]
    _check(problems, bool(fams) and fams[0] == expected_family,
           f"doctor top diagnosis {fams[:3]} != {expected_family}")
    _check(problems, doc.get("verdict") == expected_family,
           f"doctor verdict {doc.get('verdict')!r} != {expected_family}")
    log = getattr(client, "span_log", None)
    health = [s for s in (log.spans if log is not None else [])
              if s.scope == "health" and s.start_ts_ms >= t0_ms]
    _check(problems, bool(health),
           "no health.* watchdog span landed in the fault window")
    return str(doc.get("verdict"))


def _restart_checks(problems: List[str], client, plan, parity: bool, what: str,
                    parity_what: str = "result parity broken", kind: Optional[str] = None):
    """The checks every restarting scenario shares: FINISHED at parity, one
    restart, one injected fire, the injected attribution and a rewound
    checkpoint. Returns (attributed, recovery_ms)."""
    _check(problems, client.status().value == "FINISHED",
           f"job ended {client.status().value}")
    _check(problems, parity, parity_what)
    _check(problems, client.num_restarts == 1,
           f"expected 1 restart, saw {client.num_restarts}")
    _check(problems, plan.total_fired == 1,
           f"expected 1 injected {what}, fired {plan.total_fired}")
    exc = client.exceptions.payload()
    entry = exc["entries"][0] if exc["entries"] else {}
    attributed = bool(entry.get("injected"))
    _check(problems, attributed, f"injected {what} not attributed injected:true")
    recs = [r for r in exc["recoveries"] if kind is None or r.get("kind") == kind]
    recovery_ms = recs[0]["downtime_ms"] if recs else None
    _check(problems, bool(recs) and recs[0]["restored_checkpoint_id"] is not None,
           "recovery timeline missing the rewound checkpoint")
    return attributed, recovery_ms


def scenario_torn_checkpoint(device=None) -> Dict[str, Any]:
    """Every checkpoint save from the 3rd onward writes a torn `_metadata`;
    a later real failure forces a restore, which must SKIP the torn
    checkpoints and rewind to the last complete one instead of
    crash-looping."""
    device = resolve_device(device)
    problems: List[str] = []
    _oracle_client, expected = _run_mini_count_job("torn-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-torn-")
    try:
        with fault_injection(rules=[
            {"scope": "storage", "fault": "torn", "match": "save",
             "nth": 3, "max_fires": None},
        ]) as plan:
            client, results = _run_mini_count_job(
                "torn-checkpoint", device=device, chk_dir=chk,
                fail_at_ts=int(2600 * 10 * 0.7))
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected
    _check(problems, client.status().value == "FINISHED",
           f"job ended {client.status().value}")
    _check(problems, parity, "result parity broken")
    _check(problems, client.num_restarts == 1,
           f"expected 1 restart, saw {client.num_restarts}")
    _check(problems, plan.total_fired >= 1, "no torn save was injected")
    restored = (client.checkpoint_stats.last_restore or {}).get("checkpoint_id")
    _check(problems, restored == 2,
           f"restore did not skip the torn checkpoints (restored {restored}, "
           "expected 2, the last complete one)")
    recs = client.exceptions.payload()["recoveries"]
    recovery_ms = recs[0]["downtime_ms"] if recs else None
    return _result("torn-checkpoint", "mini", plan, problems, parity=parity,
                   restarts=client.num_restarts, recovery_ms=recovery_ms)


def scenario_storage_brownout(device=None) -> Dict[str, Any]:
    """Three consecutive checkpoint saves fail (storage brownout). With
    execution.checkpointing.tolerable-failed-checkpoints=5 the job rides it
    out: FAILED stats records (with injected attribution in the cause),
    zero restarts, and the consecutive-failures gauge resets once storage
    heals."""
    device = resolve_device(device)
    problems: List[str] = []
    _oracle_client, expected = _run_mini_count_job("brownout-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-brownout-")
    try:
        with fault_injection(rules=[
            {"scope": "storage", "fault": "error", "match": "save",
             "nth": 2, "max_fires": 3},
        ]) as plan:
            client, results = _run_mini_count_job(
                "storage-brownout", device=device, chk_dir=chk, tolerable=5)
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected
    _check(problems, client.status().value == "FINISHED",
           f"job ended {client.status().value}")
    _check(problems, parity, "result parity broken")
    _check(problems, client.num_restarts == 0,
           f"brownout was not tolerated: {client.num_restarts} restart(s)")
    _check(problems, plan.total_fired == 3,
           f"expected 3 injected save failures, fired {plan.total_fired}")
    gauges = client.checkpoint_stats.gauge_values()
    _check(problems, gauges["numberOfFailedCheckpoints"] >= 3,
           "tolerated failures did not land FAILED stats records")
    _check(problems, gauges["consecutiveFailedCheckpoints"] == 0,
           "consecutive-failures gauge did not reset after storage healed")
    _check(problems, gauges["numberOfCompletedCheckpoints"] >= 1,
           "no checkpoint completed after the brownout")
    failed = client.checkpoint_stats.payload()["latest"]["failed"]
    attributed = bool(failed and "[chaos-injected" in (failed.get("failure_cause") or ""))
    _check(problems, attributed, "FAILED record lost the injected-fault attribution")
    return _result("storage-brownout", "mini", plan, problems, parity=parity,
                   restarts=client.num_restarts, attributed=attributed)


def scenario_device_dispatch_error(device=None) -> Dict[str, Any]:
    """One injected error at the device dispatch boundary (the 6th window
    batch). The job must restart through the normal strategy, restore from
    the latest checkpoint, finish with exact results, and the
    ExceptionHistory entry must carry `injected: true` attribution."""
    device = resolve_device(device)
    problems: List[str] = []
    _oracle_client, expected = _run_mini_count_job("device-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-device-")
    try:
        with fault_injection(rules=[{"scope": "device", "fault": "error", "nth": 6}]) as plan:
            client, results = _run_mini_count_job("device-dispatch-error", device=device,
                                                  chk_dir=chk)
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected
    attributed, recovery_ms = _restart_checks(problems, client, plan, parity,
                                              "dispatch error")
    return _result("device-dispatch-error", "mini", plan, problems,
                   parity=parity, restarts=client.num_restarts,
                   recovery_ms=recovery_ms, attributed=attributed)


def scenario_latency_mode_restore(device=None) -> Dict[str, Any]:
    """Device dispatch error with LATENCY MODE ON (small superbatch rungs,
    in-flight ring depth 2): the fault lands while the ring can legally
    hold an unresolved dispatch. Checkpoint barriers must drain the ring
    before capture, the restart must reset ring and controller, and the
    recovered job must finish at exact parity with a plain throughput-mode
    oracle: deep async dispatch never double-emits or drops a fired window
    across restore."""
    from flink_tpu_torch.config import LatencyOptions, ObservabilityOptions

    device = resolve_device(device)
    problems: List[str] = []
    _oracle_client, expected = _run_mini_count_job("latency-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-latmode-")
    t0_ms = time.time() * 1000.0
    try:
        with fault_injection(rules=[{"scope": "device", "fault": "error", "nth": 6}]) as plan:
            client, results = _run_mini_count_job(
                "latency-mode-restore", device=device, chk_dir=chk,
                extra_config={
                    # aggressive target so the controller leaves the full
                    # span and exercises small rungs and the ring
                    LatencyOptions.TARGET_MS: 1,
                    LatencyOptions.MAX_INFLIGHT: 2,
                    # the history/doctor plane ticks fast enough that the
                    # short job fills its rings; the watchdog's p99 floor
                    # every fired window crosses gives a health.* span
                    ObservabilityOptions.HISTORY_INTERVAL_MS: 25,
                    ObservabilityOptions.DOCTOR_P99_BREACH_MS: 0.001,
                })
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected
    attributed, recovery_ms = _restart_checks(
        problems, client, plan, parity, "dispatch error",
        parity_what="latency-mode parity vs throughput oracle broken")
    verdict = _doctor_checks(problems, client, t0_ms)
    return _result("latency-mode-restore", "mini", plan, problems,
                   parity=parity, restarts=client.num_restarts,
                   recovery_ms=recovery_ms, attributed=attributed,
                   doctor=verdict)


def _run_mini_join_job(name: str, *, device, records: int = 1200, batch: int = 100,
                       chk_dir: Optional[str] = None, interval_ms: int = 1,
                       timeout_s: float = 120.0):
    """One two-input keyed windowed JOIN job on the in-process path (the
    DeviceJoinRunner seam): two generator sources, tumbling event-time
    inner equi-join, rows collected. Returns (client, sorted rows)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.config import ObservabilityOptions
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.utils.arrays import obj_array

    # the emission-latency plane is capture-eligible from the FIRST fire:
    # the restart rebuilds the join runner with a fresh tracker, so the
    # first post-restore fire's stall interval starts at the tracker's
    # mid-restart birth and its EmissionStall span overlaps the recovery
    config = _mini_config(batch=batch, key_capacity=768, chk_dir=chk_dir,
                          interval_ms=interval_ms, extra_config={
                              ObservabilityOptions.EMISSION_LATENCY_OUTLIER_MIN_SAMPLES: 1})

    def gen(side: str):
        def _gen(idx: np.ndarray) -> Batch:
            values = [(int(i % 7), f"{side}{int(i)}") for i in idx]
            return Batch(obj_array(values), (idx * 10).astype(np.int64))
        return _gen

    env = StreamExecutionEnvironment(config, device=device)
    wm = WatermarkStrategy.for_monotonous_timestamps()
    left = env.from_source(DataGeneratorSource(gen("l"), count=records), watermark_strategy=wm)
    right = env.from_source(DataGeneratorSource(gen("r"), count=records), watermark_strategy=wm)
    sink = CollectSink()
    (left.join(right)
         .where(lambda v: v[0]).equal_to(lambda v: v[0])
         .window(TumblingEventTimeWindows.of(1000))
         .apply(lambda a, b: (a[0], a[1], b[1]))
         .sink_to(sink))
    client = _execute(env, name, timeout_s)
    return client, sorted((k, left_v, right_v) for k, left_v, right_v in sink.results)


def scenario_join_restore(device=None) -> Dict[str, Any]:
    """One injected error at the device JOIN ingest boundary (the 6th ring
    ingest), mid-stream, while both sides hold live ring state inside
    unfired windows. The job must restart, restore the bucket rings from
    the latest checkpoint, and finish with EXACT results against an
    undisturbed run; the post-restore latency spike is attributed to the
    recovery span."""
    device = resolve_device(device)
    problems: List[str] = []
    _oracle_client, expected = _run_mini_join_job("join-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-join-")
    try:
        with fault_injection(rules=[{"scope": "device", "fault": "error", "nth": 6}]) as plan:
            client, results = _run_mini_join_job("join-restore", device=device, chk_dir=chk)
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected and len(expected) > 0
    attributed, recovery_ms = _restart_checks(problems, client, plan, parity,
                                              "join-ingest error",
                                              parity_what="join result parity broken")
    stalls = client.latency_report()["attribution"]
    stall_owners = stalls.get("attributed", {})
    _check(problems, stalls.get("outliers", 0) > 0,
           "no EmissionStall outlier captured across the restart")
    _check(problems,
           stall_owners.get("recovery.JobRestart", {}).get("count", 0) >= 1,
           "post-restore latency spike not attributed to recovery.JobRestart"
           f" (owners: {sorted(stall_owners)})")
    out = _result("join-restore", "mini", plan, problems,
                  parity=parity, restarts=client.num_restarts,
                  recovery_ms=recovery_ms, attributed=attributed)
    out["stall_owners"] = sorted(stall_owners)
    return out


def _degrade_checks(problems: List[str], client, shards: int, key_capacity: int) -> list:
    """The degrade policy halves the mesh on the attributed device loss.
    Returns [initial, final] shard counts."""
    from flink_tpu_torch.parallel.mesh import usable_mesh_size

    initial = usable_mesh_size(0, shards, key_capacity)
    final = client._runtime.mesh_devices()
    _check(problems, initial > 1, f"no usable mesh over {shards} shards")
    _check(problems, final == max(1, initial // 2),
           f"restart did not reduce the mesh: {initial} -> {final} "
           f"(expected {max(1, initial // 2)})")
    return [initial, final]


def scenario_chip_loss_sharded(device=None, shards: int = 4) -> Dict[str, Any]:
    """Chip loss mid-job on the sharded path: the keyed job runs over a
    mesh of `shards` shards of `device` (parallel.mesh.enabled), and one
    injected error at the device boundary models a lost chip. The job must
    recover through the attributed restart path AT A REDUCED MESH SIZE
    (parallel.mesh.degrade-on-device-loss): the canonical [K, S] checkpoint
    re-shards over the surviving shards, and results stay exactly-once
    against the one-device oracle."""
    from flink_tpu_torch.config import ParallelOptions

    device = resolve_device(device)
    problems: List[str] = []
    if shards < 2:
        # one shard: there is no mesh to lose a chip from. Reported as a
        # skip, not a pass of vacuous checks
        return _result("chip-loss-sharded", "mini", None, [],
                       parity=True, restarts=0, skipped=True)
    _oracle_client, expected = _run_mini_count_job("chip-loss-oracle", device=device)
    chk = tempfile.mkdtemp(prefix="flink-tpu-chiploss-")
    try:
        with mesh_of(device, shards), fault_injection(rules=[
                {"scope": "device", "fault": "error", "nth": 6}]) as plan:
            client, results = _run_mini_count_job(
                "chip-loss-sharded", device=device, chk_dir=chk,
                extra_config={ParallelOptions.MESH_ENABLED: True})
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    parity = results == expected
    attributed, recovery_ms = _restart_checks(
        problems, client, plan, parity, "chip loss",
        parity_what="result parity broken vs the single-chip oracle")
    mesh = _degrade_checks(problems, client, shards, 768)
    out = _result("chip-loss-sharded", "mini", plan, problems,
                  parity=parity, restarts=client.num_restarts,
                  recovery_ms=recovery_ms, attributed=attributed)
    out["mesh"] = mesh
    return out


def scenario_cold_tier_read_error(device=None) -> Dict[str, Any]:
    """One injected read error on the COLD TIER during a promotion: the
    keyed job runs with a hot capacity far below its key cardinality, so
    every batch demotes and promotes rows through the cold store, and the
    storage-scope rule errors the 60th promotion read. The job must
    restart, restore from the latest INCREMENTAL (changelog) checkpoint,
    and finish at exact parity with the untiered oracle; the tier keeps
    evicting after recovery."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.config import StateTierOptions
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.utils.arrays import obj_array

    device = resolve_device(device)
    problems: List[str] = []

    def key_of(i: int) -> int:
        # rotate each batch's key order so the batch-pinned working set
        # shifts: the vocabulary must evict the previous batch's residents
        # and promote them when they cycle back
        return int((i + (i // 200) * 17) % 64)

    def run(name: str, *, tiered: bool, chk: Optional[str] = None):
        extra = {}
        if tiered:
            # dirs under the checkpoint dir: every attempt of the job
            # shares one changelog and cold store, as a deployment does
            extra = {StateTierOptions.TIER_ENABLED: True,
                     StateTierOptions.HOT_KEY_CAPACITY: 16,
                     StateTierOptions.CHANGELOG_ENABLED: True,
                     StateTierOptions.CHANGELOG_DIR: os.path.join(chk, "changelog"),
                     StateTierOptions.COLD_DIR: os.path.join(chk, "cold")}
        config = _mini_config(batch=200, key_capacity=768, chk_dir=chk, extra_config=extra)

        def gen(idx: np.ndarray) -> Batch:
            values = [(key_of(int(i)), 1.0, int(i * 10)) for i in idx]
            return Batch(obj_array(values), (idx * 10).astype(np.int64))

        env = StreamExecutionEnvironment(config, device=device)
        stream = env.from_source(
            DataGeneratorSource(gen, count=2600, num_splits=1),
            watermark_strategy=WatermarkStrategy.for_monotonous_timestamps(),
        )
        sink = CollectSink()
        (stream.key_by(lambda x: x[0])
               .window(TumblingEventTimeWindows.of(1000)).count()
               .sink_to(sink))
        client = _execute(env, name, 120)
        return client, sorted((int(k), int(n)) for k, n in sink.results)

    _oracle_client, expected = run("cold-tier-oracle", tiered=False)
    chk = tempfile.mkdtemp(prefix="flink-tpu-coldtier-")
    try:
        with fault_injection(rules=[
            {"scope": "storage", "fault": "error", "match": "cold-tier:get", "nth": 60},
        ]) as plan:
            client, results = run("cold-tier-read-error", tiered=True, chk=chk)
        parity = results == expected
        attributed, recovery_ms = _restart_checks(
            problems, client, plan, parity, "cold-tier error",
            parity_what="result parity broken vs untired oracle")
        # the restored checkpoint must be the INCREMENTAL kind, and the
        # tier must still be bounded and churning after recovery
        tier = None
        for e in client._runtime.device_snapshot()["operators"].values():
            if e.get("tier"):
                tier = e["tier"]
        _check(problems, tier is not None, "tier payload missing")
        if tier is not None:
            _check(problems, bool(tier["changelogEnabled"]),
                   "checkpoints were not incremental (changelog off)")
            _check(problems, tier["residentKeys"] <= 16,
                   f"resident keys {tier['residentKeys']} exceed the cap")
            _check(problems, tier["evictions"] > 0 and tier["promotions"] > 0,
                   "no eviction/promotion churn: the seam under test never ran")
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    return _result("cold-tier-read-error", "mini", plan, problems,
                   parity=parity, restarts=client.num_restarts,
                   recovery_ms=recovery_ms, attributed=attributed)


def scenario_chip_loss_during_rebalance(device=None, shards: int = 4) -> Dict[str, Any]:
    """Chip loss against the SKEW-REBALANCED mesh: a zipf-shaped keyed job
    piles its hot key-groups onto shard 0, the rebalancer remaps them
    across the mesh at a step-aligned boundary, and an injected device
    error then kills a chip while the job runs on the remapped routing
    table. The job must recover through the attributed restart path at a
    REDUCED mesh size, with the routing table rebuilt consistently with the
    rewound canonical checkpoint, at parity with the one-device oracle."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.config import ExecutionOptions, ObservabilityOptions, ParallelOptions
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    device = resolve_device(device)
    problems: List[str] = []
    if shards < 2:
        return _result("chip-loss-during-rebalance", "mini", None, [],
                       parity=True, restarts=0, skipped=True)

    NUM_KEYS = 512

    def keys_of(idx: np.ndarray) -> np.ndarray:
        # ~70% of the mass on 64 hot keys. The host-keyed path assigns
        # DENSE ids in arrival order, so the hot keys take the low dense
        # ids, all in shard 0's range under the identity table, while
        # spreading over enough key-groups that a balanced replan can fix
        # it
        u = ((idx * 2654435761) % 1000) / 1000.0
        hot = (idx % 64) * 8
        cold = (idx * 40503) % NUM_KEYS
        return np.where(u < 0.7, hot, cold).astype(np.int64)

    def run(name: str, *, mesh: bool, chk: Optional[str] = None):
        extra = {
            # fast history rings and the watchdog's p99 floor, so a
            # health.* span lands
            ObservabilityOptions.HISTORY_INTERVAL_MS: 25,
            ObservabilityOptions.DOCTOR_P99_BREACH_MS: 0.001,
            # dispatch every 4 steps so device state (and the skew the
            # rebalancer reads) materializes early in the run
            ExecutionOptions.SUPERBATCH_STEPS: 4,
        }
        if mesh:
            extra.update({ParallelOptions.MESH_ENABLED: True,
                          ParallelOptions.MESH_SKEW_REBALANCE: True,
                          ParallelOptions.MESH_LOCAL_COMBINE: True,
                          ParallelOptions.MESH_REBALANCE_SKEW_THRESHOLD: 1.2,
                          ParallelOptions.MESH_REBALANCE_INTERVAL_MS: 0})
        config = _mini_config(batch=512, key_capacity=NUM_KEYS, chk_dir=chk,
                              extra_config=extra)

        def gen(idx: np.ndarray) -> Batch:
            return Batch(keys_of(idx), (idx * 2).astype(np.int64))

        env = StreamExecutionEnvironment(config, device=device)
        stream = env.from_source(
            DataGeneratorSource(gen, count=40 * 512, num_splits=1),
            watermark_strategy=WatermarkStrategy.for_monotonous_timestamps(),
        )
        sink = CollectSink()
        (stream.key_by(lambda col: col, vectorized=True)
               .window(TumblingEventTimeWindows.of(1000)).count()
               .sink_to(sink))
        client = _execute(env, name, 120)
        return client, sorted((int(k), int(n)) for k, n in sink.results)

    _oracle_client, expected = run("rebalance-oracle", mesh=False)
    chk = tempfile.mkdtemp(prefix="flink-tpu-rebal-")
    t0_ms = time.time() * 1000.0
    try:
        # the 14th device batch lands after the first rebalance (first
        # dispatch at step 4, skew visible from step ~5, the remapped table
        # live within a couple of boundaries)
        with mesh_of(device, shards), fault_injection(rules=[
                {"scope": "device", "fault": "error", "nth": 14}]) as plan:
            client, results = run("chip-loss-during-rebalance", mesh=True, chk=chk)
        parity = results == expected
        _check(problems, client.mesh_rebalances >= 1,
               "no skew rebalance completed before the injected loss: "
               "the scenario never reached the state under test")
        attributed, recovery_ms = _restart_checks(
            problems, client, plan, parity, "chip loss",
            parity_what="result parity broken vs the oracle", kind="restart")
        mesh = _degrade_checks(problems, client, shards, NUM_KEYS)
        _check(problems, client._runtime.mesh_routing_version() is not None,
               "rebuilt attempt lost its routing table")
        verdict = _doctor_checks(problems, client, t0_ms)
    finally:
        shutil.rmtree(chk, ignore_errors=True)
    out = _result("chip-loss-during-rebalance", "mini", plan, problems,
                  parity=parity, restarts=client.num_restarts,
                  recovery_ms=recovery_ms, attributed=attributed,
                  doctor=verdict)
    out["mesh"] = mesh
    return out


#: the in-process scenarios, in the JAX package's order
SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "torn-checkpoint": scenario_torn_checkpoint,
    "storage-brownout": scenario_storage_brownout,
    "device-dispatch-error": scenario_device_dispatch_error,
    "latency-mode-restore": scenario_latency_mode_restore,
    "join-restore": scenario_join_restore,
    "chip-loss-sharded": scenario_chip_loss_sharded,
    "cold-tier-read-error": scenario_cold_tier_read_error,
    "chip-loss-during-rebalance": scenario_chip_loss_during_rebalance,
}

#: the scenarios that run on a mesh and take `shards=`
MESH_SCENARIOS = ("chip-loss-sharded", "chip-loss-during-rebalance")


def run_scenario(name: str, device=None, shards: int = 4) -> Dict[str, Any]:
    """Run one scenario. A crashed scenario is a failed result, not a
    crashed matrix; a cluster scenario raises (not ported yet)."""
    if name in CLUSTER_SCENARIOS:
        raise deferred.not_ported(f"chaos scenario {name!r}", deferred.CLUSTER)
    fn = SCENARIOS[name]
    try:
        if name in MESH_SCENARIOS:
            return fn(device=device, shards=shards)
        return fn(device=device)
    except Exception as e:  # noqa: BLE001 — the remaining scenarios still run
        if active_plan() is not None:   # fault_injection unwinds its own
            uninstall_plan()            # install; this guards partial setup
        return _result(name, "?", None, [f"scenario crashed: {e!r}"])


def run_matrix(names: Optional[List[str]] = None, device=None,
               shards: int = 4) -> Dict[str, Any]:
    """Run the (selected) scenarios, by default the eight in-process ones,
    and fold the summary: scenarios_passed/total, overall parity, and the
    p50 of the observed recovery times (fail -> RUNNING downtime) across
    scenarios that recovered."""
    device = resolve_device(device)
    picked = names or list(SCENARIOS)
    for name in picked:
        if name in CLUSTER_SCENARIOS:
            raise deferred.not_ported(f"chaos scenario {name!r}", deferred.CLUSTER)
    results = [run_scenario(n, device=device, shards=shards) for n in picked]
    recoveries = [r["recovery_ms"] for r in results if r["recovery_ms"] is not None]
    return {
        "scenarios": results,
        "scenarios_total": len(results),
        "scenarios_passed": sum(1 for r in results if r["passed"]),
        "parity": all(r["parity"] for r in results),
        "recovery_time_ms_p50": (round(statistics.median(recoveries), 3)
                                 if recoveries else None),
    }
