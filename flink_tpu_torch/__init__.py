"""flink_tpu_torch: the PyTorch/CUDA port of flink_tpu's window paths.

The package mirrors `flink_tpu`'s layout and names so each module's
counterpart is easy to find, and imports neither jax nor anything of
`flink_tpu` (it keeps its own copies of the jax-free parts it needs).

What the port carries:

- `api.datastream.StreamExecutionEnvironment`: the DataStream entry path
  (`from_source().filter().key_by().window().aggregate()`), planned by
  `graph.transformation`/`graph.fusion` and run by `runtime.executor`'s
  runners over `runtime.fused_window_operator.FusedWindowOperator`. A
  `traceable=True` chain (torch column UDFs) runs as a prologue on the
  device inside each fused dispatch; otherwise the host chain and the host
  key dictionary (`state.columnar.KeyDictionary`) feed the same operator.
- `runtime.fused_window_pipeline.FusedWindowPipeline`: keyed event-time
  window aggregation, T steps per dispatch over a device-resident slice
  ring; on CUDA the dispatch runs on the hand-written Hopper kernel K1
  (`csrc/superscan.cu`), on the CPU on its plain PyTorch version.
- `runtime.fused_window_pipeline.FusedGlobalWindowPipeline`: per-window
  global aggregation (the Nexmark Q7 shape) on kernel K2
  (`csrc/global_superscan.cu`).
- `runtime.tpu_session_operator.TpuSessionWindowOperator`: event-time
  session windows (`EventTimeSessionWindows`), per batch or as a fused
  superspan, on kernels K3 (ingest) and K4 (gap-merge,
  `csrc/session_superscan.cu`); the executor selects it for session
  window steps.
- `table.TableEnvironment` and `planner`: the SQL and Table API front
  door. A windowed single-aggregate GROUP BY over a typed table lowers
  onto the fused device chain (kernel K1); other statements run
  interpreted on the operators above, with the JAX package's catalogued
  reason in `last_plan_report`.
- `runtime.oracle_window_operator.OracleWindowOperator`: the per-record
  window operator (host code) for custom triggers, evictors, `reduce`,
  `process`, Python aggregates, processing time, GlobalWindows without a
  count trigger and SQL's multi-aggregate SELECTs; the executor selects it
  under the JAX runner's conditions.
- `scheduler.latency_controller`: latency mode's rung controller; with
  `execution.latency.target-ms` set the fused operator cuts dispatches at
  its rung and reads each back in groups of steps.
- `testing.stream`: the counter-hash stream generators (on the card and
  bit-identical on the host), the numpy window and session oracles and
  the parity check.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit device they raise instead of falling back.
"""
