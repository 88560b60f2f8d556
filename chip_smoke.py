#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `flink_tpu_torch` (never jax, never `flink_tpu`) through the entry
points a user calls, at the geometries of the repo's YSB benchmark, and
exits non-zero on the first failure. Phases, one JSON line each:

1. device: the card (name and power limit as nvidia-smi gives them), the
   build of the Hopper kernels from `flink_tpu_torch/csrc/` and of the
   cold tier's native spill store from `native/*.cpp` (g++);
2. kernel K1 (keyed superscan) against its plain PyTorch version on the
   card at the YSB geometry (K=8192, S=32, NSB=4, F=4, R=64, T=48, B=2^20)
   with plans from the port's planner, for count, sum and max8: bit-equal;
3. kernel K2 (global superscan) against its plain version at the Nexmark
   Q7 geometry (S=8, NSB=2, F=4, R=16, T=96, B=2^18) for add, min and max:
   bit-equal;
4. main path: YSB sliding count (10 s windows sliding by 1 s) through
   FusedWindowPipeline on the on-card generator, 8 spans pipelined 3 deep,
   checked window by window against the numpy oracle's replay;
5. WordCount tumbling count and the Q7 global max, each with its parity
   check and launch count;
6. kernel times at the main paths' shapes beside their bounds, the plain
   versions' times, the device time of each CUDA kernel of a dispatch
   (torch.profiler) and one PyTorch call as a yardstick (for K1 the
   dispatch's ingest as one atomic `index_add_`, with the sort-based
   `index_put_(accumulate=True)` of earlier runs beside it);
7. device time by kernel for each path, from one more run of it under
   torch.profiler, and the share of its wall time the device was busy;
8. api_ysb, this slice's main path: YSB written as a DataStream job
   (`bench.py::api_path_microbench`'s program: a traceable filter keeping
   one record in three, a traceable key, 10 s windows sliding by 1 s,
   `count`, 8192 keys, batch 65536, 32 steps a superbatch) run through the
   port's API, planner, runners and operator on both routes — the fused
   device chain (torch prologue + K1) and the host chain (host key
   dictionary + K1). Parity in row mode at 2^21 records, three ways (both
   routes and the numpy oracle over the same columns), plus a tumbling sum
   whose traceable value_fn feeds K1's add field; then tuples/s at 2^24
   records (fused) and 2^22 (host chain) with columnar output, the K1
   dispatches of each run, one run of each route under torch.profiler
   and one under cProfile (host time by function), and K1 against its
   plain version at this path's shapes (the job's first full fused
   dispatch, count and the prologue-fed sum: T=32, B=65536, K=8192,
   R=256) with its times. The kernels line reports K1 at these shapes
   (and at phase 6's under "ysb_generator"); each entry names its shape.
   A bound counts as output the fire rows the dispatch writes, not all R.
9. session_sum: `bench.py::secondary_sessions` on the port's session
   operator (kernels K3 and K4): gap 2000 ms, 64 gap-slices, 2^14 keys in
   four rotating blocks, 2^20 records a step made on the card, 16 steps a
   superspan merging after steps 7 and 15, a final watermark 2^60. One
   superspan (2^24 records) is held against `numpy_sessionize` over the
   host replay and against the per-step route; 4 superspans (2^26
   records) are timed after a warm run; the operator's exact fallbacks
   (host merges, superspan replays) must stay 0;
10. api_sessions: a session DataStream job (`key_by(traceable key)
   .window(EventTimeSessionWindows.with_gap(2000)).aggregate("sum")`) over
   2^22 records of the same stream made on the host, batch 65536, held
   against `numpy_sessionize`;
11. K3 and K4 against their plain versions at these shapes (bit-equal),
   with times, bounds and, for K3, the PyTorch scatter calls its plain
   version makes as the yardstick. The profiles of phase 7 include
   session_sum (by kernel: generator, K3, K4, copies) and the host profile
   of api_sessions.
12-16. the per-batch paths: lateness_operator, api_lateness,
   api_count_window, api_group_agg, and the per-batch torch programs;
17. api_sql: `bench.py::sql_path_microbench`'s statement and columnar
   table (8192 keys, HOP 10 s / 1 s, batch 8192) through the port's parser,
   planner and TableEnvironment: the fused runner selected, three-way
   parity at 2^17 records (SQL fused, SQL interpreted, the DataStream
   program) against the numpy oracle, tuples/s fused at 2^21 and
   interpreted at 2^17 with their K1 dispatches; a TUMBLE SUM ... HAVING
   over 2^20 typed dict rows (host columnarizer, K1's add field) against
   numpy; the SESSION fallback statement on K3/K4 against
   numpy_sessionize; a continuous COUNT/SUM/AVG GROUP BY over 2^18
   changelog rows on the device accumulators against the host path; and
   K1 against its plain version at the SQL job's first full dispatch.
18. api_latency: the api_ysb fused program at 2^22 records in latency
   mode (execution.latency.target-ms 50, readback-steps 8,
   max-inflight-dispatches 2) beside throughput mode, and with the
   controller pinned at each rung of its ladder (2 ... 32 steps a
   dispatch): every run's rows equal the throughput run's in order and
   the numpy oracle's; a full-depth dispatch is 4 K1 launches; tuples/s,
   the time from the run's start to the first row at the sink and the mean
   lag from a dispatch's enqueue to its rows at the sink, in both modes;
   then K1 at the readback group's shape (8 steps of 65536 records), and
   ROADMAP C3 on the card: the fused operator's int64 sum on C3's inputs
   gives the JAX package's rows, and K1 with an int32 add field is
   bit-equal to its plain version on quarter values at the sum job's
   dispatch (`k1_int_sum`).
19. api_oracle: the per-record oracle operator's jobs (host code, no
   kernel launches): 10 s / 1 s windows with ContinuousEventTimeTrigger.of
   (500) and reduce over 2^16 records and 1024 keys, 2 s tumbling windows
   with CountEvictor.of(16) and process, each against a numpy model of its
   semantics; SQL_MULTI (COUNT(*), SUM(x), MAX(x) over the YSB HOP) at
   2^17 records against numpy, its plan report the JAX package's; tuples/s
   of each, and a cProfile of the two DataStream jobs.
20. api_correlated: shared correlated windows (graph/window_sharing.py).
   `bench.py::correlated_windows_microbench`'s program (a traceable filter
   and key, 1 min / 5 min / 1 h tumbling counts, 8192 keys, batch 65536):
   in row mode at 2^19 records the shared program (one SharedWindowRunner
   and two siblings), the same job with execution.window.shared-partials
   false and a numpy model, window by window; shared and independent
   interleaved at 2^22 records, columnar, best of 3, with their K1
   launches. A five-member group on a 1 min granule (1, 5, 15, 60 min
   tumbling, 10 min sliding by 1: F = 20, mixed per-slot window lengths)
   at 2^20 keys and 2^22 records, shared and independent equal array for
   array. Leg 1's program in latency mode at 2^21 records, its rows equal
   throughput mode's in order. Then K1 against its plain version at the
   wide group's first shared dispatch and at an unstaged ring (a 24 h
   window sliding by 1 min beside 1 min: spw 1440, S = 2048), with times.
21. api_tiered: the million-key state plane (`bench.py::millikey_microbench`'s
   program: a vectorized key_by, 10 s windows sliding by 1 s, count, batch
   8192, state.tier.* with hot capacity 4096 and admission 2, the changelog
   on) through the port's executor. Leg A at 2^16 records over 2^15 keys
   (hot capacity 4096): the tiered rows equal the untiered fused job's and
   the numpy oracle's, uniform and zipf, with evictions. Leg B at 2^18
   records over 10^7 keys: oracle parity, resident keys <= 4096, records
   routed cold, evictions under zipf, the cold tier native, tuples/s of one
   run and the tier's gauges. Leg C: the row surface (gather_key_rows,
   clear_key_rows, write_cells, gather_cells) on [S, K] = [32, 2^20] rings,
   2^16 rows, equal to the CPU result, each against its bytes bound. Then
   K1 at leg B's first full dispatch (K = 4096, B = 8192, T = 32), a
   device profile of each leg B variant and a host profile of zipf's, at
   2^15 records.
22. api_checkpoint: job checkpoints, restart strategies and savepoints,
   every job through env.execute_async on the port's MiniCluster (a
   job thread each). Leg A: api_ysb's program at 2^21 records in row mode,
   with checkpoints off and at 25 ms into a directory, restart-strategy
   fixed-delay at 1 ms: tuples/s on and off and K1's launches each way;
   then at 1 ms (every step) and at 25 ms, each with one host failure
   raised by the sink writer at 60% of the event time: one restart from a
   reported checkpoint, the rows equal the uninterrupted run's and the
   numpy oracle's, the device memory at the restarted attempt's first
   sink batch within 512 KiB of the first attempt's; and the same job into
   a FileSink, whose committed part files hold exactly those rows. Leg B:
   the program at 2^20 keys with a float32 sum (rings [32, 2^20] x 2,
   256 MiB), columnar, checkpoints every 40 ms (at least four): oracle
   parity; the capture and restore of those rings by part (on-card
   transposition, copy to the host, pickle, fsync, load, copy back) against
   bounds from one large pinned copy_ each way in the same run; then a
   savepoint at half the input (the source held on an Event), cancel, and
   a new job resumed from it with MiniCluster.submit(savepoint_restore_path
   =): records_in complete, every window of the oracle once. Leg C:
   api_tiered's zipf job (2^17 records over 10^7 keys) with a checkpoint
   at every step, each an incremental (base, log offset) changelog handle,
   and one host failure in the source: the oracle's rows after the restore
   from the handle, incremental_ratio (millikey_microbench's) below 0.25.
   Then a host profile of leg A's job at 25 ms, driven on the main thread.

23. api_join: two-input joins (`bench.py::join_microbench`'s NEXMark q3,
   persons JOIN auctions ON seller with the auctions' category filter over
   2 s windows sliding by 1 s, and q8, the same join over a 1 s tumble),
   every job through the port's API with the bench's streams copied. Leg
   A at the bench's defaults (2048 keys, batch 1024, 2^14 records a side
   over 64 s), uniform and zipf(1.0): the factory selects the
   DeviceJoinRunner, its rows equal the host WindowJoinRunner's (device
   joins off) and a numpy window equi-join model's, zipf grows the bucket
   capacity with no degrade. Leg B: q8 uniform at 2^16 keys (the key
   capacity's default) and 2^20 records a side: K doubles 1024 -> 65536,
   ~1.09 GB of rings on the card (NB = 65, C = 16), parity, device and
   host tuples/s of one run each. Leg C: the bench's q8 statement fused
   (sql_origin), with device joins off and with table.device-fusion off,
   at parity with a model; FULL OUTER refused (join-full-outer); regular
   INNER and LEFT OUTER joins on the StreamingJoinRunner against a model.
   Leg D: the catalogued degrades, join-ring-overflow (16 slots, zipf) and
   join-key-capacity (1024 lanes for 2048 keys), rows equal to the host
   route's. Leg E: q8 at 2^16 records a side through env.execute_async
   with 25 ms checkpoints and one host failure in the sink at 60% of the
   event time: one restart, rows equal the uninterrupted run's and the
   model's, device memory bounded as in phase 22. Then leg B's job under
   torch.profiler and cProfile at half its records, and the join ring's
   programs (ROADMAP B5, torch code) on the per-batch-programs line at leg
   B's geometry.

24. api_mesh: the mesh (parallel/, parallel.mesh.*) on four shards of
   the one card (`parallel/mesh.py::visible_devices` replaced for the
   phase with four copies of cuda:0; the shards time-share the card, so
   a mesh-to-card tuples/s ratio measures the mesh's overhead, not
   scaling). Leg A: `bench.py::multichip_microbench`'s program (a
   traceable filter keeping one record in three, a traceable key, 10 s
   windows sliding by 1 s, count, 8192 keys, batch 8192, 64 s of event
   time), uniform and zipf(1.0) keys, in row mode at 2^17 records: the
   mesh job, the mesh job with local-combine, the one-card job and a
   numpy model, window by window; the fused runner on the sharded
   pipeline (`sharded_selected`), K1 launched once per shard (4x the
   card's launches); tuples/s of mesh and card at 2^20, best of 2,
   interleaved. Leg B: api_checkpoint leg B's program (2^20 keys, a
   float32 sum, rings [32, 2^20] x 2) at 2^21 records, columnar: the
   card, the mesh and the mesh with local-combine (its partials crossing
   in step groups under K1's partials budget) against the oracle with
   their peak device memory; a
   live `JobClient.rescale_mesh(2)` at half the input through
   execute_async, exactly-once; a savepoint at half of a 4-shard run
   restored on one card and on a 2-shard mesh. Leg C: the sharded
   per-batch operator at 2^20 keys against `TpuWindowOperator`, columnar;
   NEXMark q8 at api_join leg A's defaults with the mesh on
   (`DeviceJoinRunner.sharded`), rows equal the one-ring job's. Then K1
   against its plain version at shard 0's exchanged lanes of leg A's
   first full dispatch (`k1_mesh_shard`) and K1's partials entry at its
   folded partials (`k1_partials`), bit-equal, with times and bounds; the
   mesh's torch programs (B4, B7, B8) with times and bounds; leg A's mesh
   run under torch.profiler (raw and local-combine) and cProfile.

25. api_metrics: the metric planes every job runs (flink_tpu_torch/
   metrics/: the registry, latency markers, device timing, emission
   latency, checkpoint spans, the history and the doctor). Leg A:
   api_ysb's fused program (columnar) at 2^22 records through
   env.execute_async with checkpoints every 100 ms, a latency marker every
   5 ms, emission latency and the doctor on and the history every 50 ms:
   its rows against the same job with every plane off and the numpy model;
   job.numRecordsIn 2^22 and each operator's numRecordsIn the records that
   reached it; a latencyMs histogram on every operator; the emission count
   equal to the fires the operator resolved; p99EmissionLatencyMs finite
   and above 0; deviceTimeMsTotal above 0 and within the wall;
   deviceDispatches equal to the sections the runner entered; the
   checkpoint gauges and one completed checkpoint span per checkpoint;
   the three reports with the JAX client's keys. Leg B: the job with the
   defaults against every plane off, off/on/on/off, tuples/s and their
   ratio; one run with the defaults under torch.profiler beside its
   deviceTimeMsTotal; then (after the phase's line) a host profile of
   that job on this thread. Leg C at small sizes: NEXMark q8 at api_join
   leg A's defaults (the join gauge family, one stamp a window with
   matches), the tiered job at api_tiered leg A's size (the tier gauges),
   latency mode (its controller gauges), a per-batch lateness job (one
   stamp a fired window) and a session job (one stamp a session).

26. api_device: the device plane every fused job runs (flink_tpu_torch/
   metrics/device_stats.py, key_stats.py, K1's and K2's phase counters).
   Leg A: `bench.py::device_plane_microbench`'s program (a traceable
   filter keeping one record in three, a traceable key over 8192 keys,
   10 s windows sliding by 1 s, count, batch 8192, 8 steps a dispatch,
   columnar) at 2^22 records through env.execute_async with the defaults
   and the card's roofline figures (3350 GB/s, 67 TFLOP/s): its rows
   against the plane-off job and the numpy model; phaseIngestRecords the
   filter's survivors, phaseFireSteps and phasePurgeSteps the planner's
   fire slots and purge steps; compiles with the JAX signature keys and
   one device.XlaCompile span each; keySkew in [1, 1.5] on the uniform
   keys; hbmUtilizationPct in (0, 100], printed beside the same bytes
   over the profiler's device time of a run; device_snapshot() with the
   JAX payload's keys; then the first job after a cold build of K1's
   library (into a temporary directory): compileTimeMsTotal holds the
   nvcc build. Leg B: bench.py's ring-doubling sequence on a
   FusedWindowOperator: a ring-doubling recompile cause. Leg C: leg A's
   job with the plane on and off (off, on, on, off), tuples/s and their
   median ratio, and a host profile of an on run. Leg D: api_mesh leg A's
   job on four shards with the plane on: keySkewPerDevice per shard, the
   shards' ingest count summed equal to the one-card job's, K1 once per
   shard. Leg E: a small fused job with observability.profiler.*: one
   capture, its trace naming K1's kernels. Every K1 and K2 check of the
   earlier phases runs with a phase-counter buffer and holds the three
   counts against the plain version's too; the kernels line gives each
   K1/K2 time with the counters on (`ms`, a job's default) and off
   (`ms_phases_off`), in one call.

27. api_mesh_features: the main path's features on four shards of the
   card (visible_devices replaced, as in phase 24). Leg A:
   `bench.py::correlated_windows_microbench`'s program (1 min / 5 min /
   1 h tumbling counts, 8192 keys, batch 65536, 2 h of event time): in
   row mode at 2^19 records the shared mesh job, the independent mesh
   job, the shared one-card job and the numpy model window by window;
   columnar at 2^22, interleaved, best of 2, their tuples/s and K1's
   launches (four a shared mesh dispatch); phase 20's five-member group
   (F = 20) at 2^20 keys and 2^22 records on the mesh, array for array
   against the one-card run. Leg B: `millikey_microbench`'s program: its
   sharded_parity (2^15 records over 2^15 keys, hot capacity 4096,
   admission 1, checkpoints every 1 ms) against the untiered mesh job and
   the numpy oracle; 2^17 records over 10^7 zipf keys, hot capacity 4096
   over the shards (oracle parity, residency, cold routing, the gauges);
   the sharded row surface on [32, 2^20] rings with 2^16 rows against
   the CPU, each call against its bytes bound. Leg C: 64 keys'
   query_state_for on the 4-shard operator against the one-card one at
   three points of the input; a savepoint at half of leg A's shared mesh
   run restored on one card and on 2 shards. Then K1 against its plain
   version at shard 0's first full shared dispatch of leg A's wide group
   (`k1_mesh_shared`).

28. api_mesh_control: the mesh's control loops on four shards of the card
   (visible_devices replaced, as in phases 24 and 27). Leg A, the skew
   rebalancer: `bench.py::skew_matrix_microbench`'s adaptive program
   (2^19 records, 8192 keys, batch 2048, 8 steps a dispatch, the bench's
   traceable filter, which keeps every record, a traceable key, 10 s windows
   sliding by 1 s, count, 64 s of event time; zipf(1.0) keys with the hot
   ranks one per key group of shard 0; local-combine, skew-rebalance at
   threshold 1.2 and interval 0, device stats on): in row mode at 2^16
   the rebalanced mesh job, the one-card job and the numpy model equal;
   the static table's meshLoadSkew; the uniform and zipf adaptive jobs'
   tuples/s, rebalances, table version, recoveries (kind "rebalance"),
   routing block and post-rebalance skew (below the static one). Leg B,
   the autoscaler: the uniform program with autoscaler.enabled and
   parallel.mesh.autoscale, its source held at 2^17 records while the
   coordinator's executor rejects a same-size target and takes 4 -> 2;
   the job ends on 2 shards with the one-card job's rows; no local
   combine, so K1's keyed (lane) entry runs on every shard. Leg C, the
   device-loss degrade: leg B's job with checkpoints every 5 ms and a
   device-scoped chaos marker raised at the sixth sharded dispatch: one
   restart, 4 -> 2 shards from a restored checkpoint, the one-card rows.
   Then K1's partials entry against its plain version at shard 0's first
   full dispatch under leg A's rebalanced table (`k1_mesh_routed`), and
   the table swap (`set_mesh_routing`) against its bytes bound.

29. api_topologies: the rest of the DataStream API (union and connect,
   keyed reduce and process with side outputs, iterations, async I/O, CEP,
   API V2, operator coordinators) and SQL UNION ALL. Leg A:
   `bench.py::api_path_microbench`'s program over `a.union(b)`, two
   sources holding the api stream's even and odd records, each with the
   program's watermark strategy: the fused runner downstream of the
   UnionRunner; in row mode at 2^21 records the union job, the
   single-source job (phase 8's) and the numpy oracle window by window;
   columnar at 2^22, union and single interleaved, best of 2, with each
   run's K1 launches. Leg B at 2^18 records over 8192 campaigns of 10 ads:
   a map_batch joins each batch's ads to their campaigns with one lookup
   and feeds a 1 s tumbling payload sum; a keyed process() routes the
   clicks to a side output that feeds a 10 s / 1 s sliding count; both on
   host-keyed fused operators (K1), both sinks against numpy. Leg C at
   2^16 records over 1024 keys, each against a model: keyed reduce with
   query_state while the source is held; connect(...).key_by(...)
   .process(...) of impressions and clicks sharing per-key state with an
   event-time timer; the broadcast state pattern; an iteration's decrement
   loop and its max_rounds guard; async_map ordered and unordered at
   capacity 16 over a local function that sleeps; CEP begin().next()
   within 10 s; an API V2 keyed process; a keyed process with an operator
   coordinator, run with a checkpoint every step and one host failure at
   60% of the records: one restart, the uninterrupted run's rows and the
   coordinator's count restored. Leg D: SQL_YSB and its purchases twin
   joined by UNION ALL over sql_path_microbench's table at 2^19 records:
   the JAX package's plan report, the rows equal to each statement alone,
   united, and to numpy, K1 launched. Then K1 against its plain version
   at leg A's first full union dispatch (`k1_union`), and leg A's union
   job under torch.profiler and cProfile.
30. api_chaos: the chaos plane's drills (chaos/scenarios.py, chaos/plan.py)
   on the card. Leg 0: the eight in-process scenarios at the JAX package's
   sizes (2600 records, batch 200, key capacity 768, 1 ms checkpoints, the
   JAX rules), the mesh ones on four shards of the card: each passed, none
   skipped, each fired, attributed where the JAX gate asks, the mesh 4 -> 2
   in both chip-loss scenarios. Legs A and B: api_ysb's program (columnar)
   at 2^22 records with checkpoints every 25 ms, uninterrupted, then under
   an injected device error at its 40th of 64 batches (leg A: one restart
   from a checkpoint, the injected attribution, downtime, tuples/s against
   the uninterrupted run, the restarted attempt's device memory within 512
   KiB of the first's), then with every checkpoint from the 3rd torn and a
   real failure at 60% of event time (leg B: the restore behind the torn
   checkpoints, at checkpoint 2); each with the uninterrupted run's rows.
   Leg C: api_mesh leg A's program at 2^20 records on four shards with
   parallel.mesh.degrade-on-device-loss and an injected device error at
   its 77th of 128 batches: one restart on 2 shards, the one-card rows.
   Then K1 against its plain version at leg A's restarted attempt's widest
   dispatch (the most steps; checkpoints flush shorter ones), from the ring
   it found (`k1_recovered`).
31. api_state_tools: the State Processor API and the formats on the card.
   Leg A: api_ysb's tumbling sum job (K1's add field) at 2^22 records, a
   savepoint at half its batches: SavepointReader's keyed state of the
   fused operator equal to the numpy model of the records before
   records_in() (count and sum per key and window), SavepointWriter's sum x
   10, the job resumed on the card: its rows and total equal to the model
   with the in-flight cells patched; then K1 against its plain version at
   the resumed job's widest dispatch over the patched ring (`k1_patched`).
   Leg B: 2^18 of api_ysb's records written by FormattedFileSink as CSV,
   JSON lines and Avro (each codec's host MB/s), each read back by
   FormattedFileSource into api_ysb's count program on the card, rows equal
   to the columnar job's.
32. api_cluster: the distributed cluster (runtime/cluster.py) on the card,
   transport security on (an ephemeral secret; a secret file for leg E).
   Leg A: api_ysb's fused program (columnar) at 2^22 records as a
   GraphJobSpec on one in-process JobManager and two TaskExecutors: rows
   equal to the local run and the numpy oracle, K1's launches in the
   TaskExecutor, cluster and local tuples/s. Leg B: the same program split
   before the window (two stages on two TaskExecutors over the binary
   wire) at 2^21 records, paced 0.1 s a batch, checkpoints every 0.2 s; a
   TaskExecutor stopped after the first completed checkpoint and another
   connected: FINISHED with the uninterrupted rows, the restored
   checkpoint, the window stage's runner, the exchange's byte counters and
   the device memory at the restarted attempt's first sink batch within
   512 KiB of the first attempt's.
   Leg C: a DistributedJobSpec on two shards, operator "device": a 10 s /
   1 s sliding count (TpuWindowOperator) and a session sum, gap 2000 ms
   (TpuSessionWindowOperator, K3/K4), over 2^20 records each, equal to
   numpy. Leg D: SQL ML_PREDICT over a two-layer MLP on 2^16 rows, equal to
   the CPU's scores within 1e-5. Leg E: a jobmanager and a taskmanager
   process, leg A's job at 2^20 records equal to the local run. Then K1
   against its plain version at leg A's TaskExecutor's first full and
   widest dispatches (`k1_cluster`), and the planes' host rates (binary
   wire encode/decode MB/s, handshake ms).
33. api_cluster_ops: the chaos plane's cluster drills, and the HTTP planes
   and the CLI, over the cluster and the MiniCluster on the card. Leg A:
   the four cluster scenarios (rpc-flap, dataplane-blip,
   tm-crash-during-rescale, heartbeat-partition) through run_matrix with
   their TaskExecutors on the card, at the JAX package's sizes, rules and
   gates. Leg B: api_cluster leg B's two-stage program (2^21 records, three
   TaskExecutors, checkpoints every 0.2 s, a 5 s heartbeat timeout) under
   two of those drills' fault plans: an injected error on the stage edge's
   5th send after the first checkpoint (the stage fails over, as in the JAX
   package: a restart from a checkpoint), then, paced 0.3
   s a batch, a partition of the heartbeats of the TaskExecutor that holds
   the window stage for 80 beats (8 s at its 0.1 s beat; the JAX drill
   drops 35 against a 1.2 s timeout): a restart from a checkpoint, the loss
   attributed to that TaskExecutor; each with the uninterrupted rows and
   K1 launched in a TaskExecutor in every attempt; then K1 against its
   plain version at the restarted attempt's widest dispatch
   (`k1_cluster_faulted`). Leg C: a RestServer on port 0 over a MiniCluster,
   with leg B's JobManager as its jm_gateway. api_ysb's fused program at
   2^22 records submitted by `cli.frontend.main(["run", ..., "--address",
   url])` (POST /jars/run): `list`, `info`, Prometheus /metrics with the
   job's gauges, /jobs/<id>/device with its phase counters equal to what the
   planner gave K1 and its dispatches equal to K1's launches; a paced
   checkpointed job: checkpoints, exceptions, a savepoint through the CLI,
   cancel, the dashboard with its device table and a flame graph taken
   while it runs; leg B's cluster job through the bridge.
34. lint: `python -m flink_tpu_torch.lint --format json` once, in a
   process of its own, over the port as installed here with its baseline
   (lint_baseline_torch.json): modules, rules (16), active violations (0),
   baselined (9), the analysis time and the exit code (0), beside the
   card's line, and whether that process loaded torch (it must not: the
   analyzer reads ASTs and imports nothing it checks).

Then a {"kernels": [...]} line, the nvidia-smi line again, and last
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12         # H100 SXM float32/int32 outside the tensor cores

YSB = dict(K=8192, S=32, NSB=4, F=4, R=64, T=48, B=1 << 20, spans=8, depth=3)
WORDCOUNT = dict(T=24, B=1 << 20, spans=2, depth=2)
Q7 = dict(S=8, NSB=2, F=4, R=16, T=96, B=1 << 18, spans=5, depth=3)
# the DataStream job (bench.py::api_path_microbench's program): the
# default batch 65536 and 32 steps a superbatch, so the ring is [32, 8192]
API = dict(keys=8192, window=10_000, slide=1_000, sum_window=2_000, batch=65536,
           fused_events=1 << 24, chain_events=1 << 22, parity_events=1 << 21,
           warmup_events=1 << 19, runs=2)
# bench.py::secondary_sessions: gap 2000 ms, 64 gap-slices, 2^14 keys in four
# rotating blocks, 2^20 records a step, 16 steps a superspan merging after
# steps 7 and 15; parity over one superspan, 4 timed
SESSIONS = dict(gap=2000, S=64, K=1 << 14, B=1 << 20, T=16, merge_every=8, spans=4)
# the session DataStream job: 2^22 records at batch 65536, one batch a step
API_SESSIONS = dict(events=1 << 22, batch=65536, runs=2)
# the per-batch operator with allowed lateness at real state size: 2^20
# keys, 2^20 records a batch (~1 s of event time), 2 warm-up batches and 16
# timed; its DataStream job; the count window; the continuous aggregate
LATENESS = dict(K=1 << 20, B=1 << 20, warm=2, timed=16, lateness=2000)
API_LATENESS = dict(keys=8192, batch=65536, events=1 << 22, lateness=2000)
API_COUNT = dict(keys=1 << 16, hot_keys=1024, n=64, batch=65536, events=1 << 22,
                 nonpurging_events=1 << 20)
API_GROUP_AGG = dict(keys=1 << 16, rows=1 << 20, retract=0.1, batch=65536)
# the SQL front door at bench.py::sql_path_microbench's geometry: 8192 keys,
# HOP 10 s / 1 s, batch 8192, 2^21 records over 64 s of event time; parity
# and the interpreted route at 2^17; a typed row-mode table of 2^20 dict
# rows; the continuous GROUP BY over 2^18 changelog rows
API_SQL = dict(keys=8192, window=10_000, slide=1_000, batch=8192, events=1 << 21,
               parity_events=1 << 17, interp_events=1 << 17, warmup_events=1 << 16,
               rows=1 << 20, rows_batch=65536, tumble=2_000, having=10,
               group_rows=1 << 18, group_keys=1 << 16, session_rows=512, runs=2)
SQL_YSB = ("SELECT campaign, COUNT(*) AS views, WINDOW_END AS wend FROM ysb "
           "WHERE event_type < 0.5 GROUP BY campaign, "
           "HOP(rowtime, INTERVAL '1000' MILLISECOND, INTERVAL '10000' MILLISECOND)")
# latency mode on the api_ysb program: 2^22 records, the controller's
# target 50 ms, readback groups of 8 steps, two dispatches in flight
API_LATENCY = dict(events=1 << 22, warmup_events=1 << 19, target_ms=50, readback_steps=8,
                   max_inflight=2)
# the per-record oracle operator's jobs: 1024 keys; 10 s / 1 s windows with
# ContinuousEventTimeTrigger.of(500) and reduce over 2^16 records spanning
# 4 s of event time (batch 256, so a watermark advances ~16 ms, less than
# the interval); 2 s tumbling windows with CountEvictor.of(16) and process
# over 2^16 records spanning 16 s; SQL_MULTI over 2^17 records
API_ORACLE = dict(keys=1024,
                  continuous_reduce=dict(events=1 << 16, span_ms=4_000, batch=256,
                                         window=10_000, slide=1_000, interval=500),
                  evictor_process=dict(events=1 << 16, span_ms=16_000, batch=1024,
                                       window=2_000, keep=16),
                  sql_events=1 << 17, sql_batch=8192)
SQL_MULTI = ("SELECT campaign, COUNT(*) AS views, SUM(x) AS s, MAX(x) AS m, "
             "WINDOW_END AS wend FROM ysb WHERE event_type < 0.5 GROUP BY campaign, "
             "HOP(rowtime, INTERVAL '1000' MILLISECOND, INTERVAL '10000' MILLISECOND)")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the scalar peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2/3 helpers: kernel against plain version on the same inputs
# ---------------------------------------------------------------------------

def _fresh_rings(agg, shape, dev, global_scope):
    from flink_tpu_torch.ops.aggregators import scan_identity, torch_dtype
    from flink_tpu_torch.ops.superscan import value_fields

    count = torch.zeros(shape, dtype=torch.int32, device=dev)
    states = []
    for f in value_fields(agg):
        ident = scan_identity(np.dtype(f.dtype), f.scatter) if global_scope else f.device_identity
        states.append(torch.full(shape, ident, dtype=torch_dtype(f.dtype), device=dev))
    return count, states


def _max_abs_err(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def _phase():
    """A zeroed int32[3] phase-counter buffer, as the pipelines allocate
    one a dispatch."""
    return torch.zeros(3, dtype=torch.int32, device=DEV)


def on_off_ms(call, reps: int = 10) -> dict:
    """CUDA-event ms of call(phase) with the phase counters on (a fresh
    zeroed buffer a call, as the pipelines pass it) and off (None), in the
    order off, on, on, off; each side the mean of its two timings."""
    from flink_tpu_torch.testing.timing import cuda_ms

    t = {"on": [], "off": []}
    for side in ("off", "on", "on", "off"):
        t[side].append(cuda_ms(lambda: call(_phase() if side == "on" else None), reps))
    return {"ms": float(np.mean(t["on"])), "ms_phases_off": float(np.mean(t["off"])),
            "on_over_off": float(np.mean(t["on"]) / max(np.mean(t["off"]), 1e-12))}


def _ring_copies(agg, shape, global_scope, rings):
    """Fresh rings, or copies of `rings` (count, states) when given."""
    if rings is None:
        return _fresh_rings(agg, shape, DEV, global_scope)
    return rings[0].clone(), [x.clone() for x in rings[1]]


def compare_kernel(kernel, plain, agg, spans, shape, global_scope, rings=None, **kw):
    """Run kernel and plain version over the same chained dispatches from
    the same initial rings (fresh ones, or copies of `rings`), each
    dispatch with its own phase-counter buffer; return the largest absolute
    difference of any ring, fire row or phase count (requires bit
    equality)."""
    kc, ks = _ring_copies(agg, shape, global_scope, rings)
    pc, pst = _ring_copies(agg, shape, global_scope, rings)
    err = 0.0
    for idx, vals, plan in spans:
        kph, pph = _phase(), _phase()
        kout = kernel(agg, kc, ks, idx, vals, plan[:5], phase=kph, **kw)
        pout = plain(agg, pc, pst, idx, vals, plan[:5], phase=pph, **kw)
        torch.cuda.synchronize()
        pairs = ([(kc, pc), (kout[0], pout[0]), (kph, pph)] + list(zip(ks, pst))
                 + list(zip(kout[1], pout[1])))
        for a, b in pairs:
            err = max(err, _max_abs_err(a, b))
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel.__name__} differs from its plain "
                                     f"version for {agg.name}: max |diff| {err}")
    return err


def stage(pipe, gen, lo, T, B, slide_ms):
    """Plan the span of steps [lo, lo+T) with the port's planner and
    generate its records on the card: a `staged` tuple."""
    from flink_tpu_torch.testing.stream import step_bounds, watermark_after

    bounds = [step_bounds(lo + r, B, slide_ms) for r in range(T)]
    wms = [watermark_after(lo + r) for r in range(T)]
    plan, smin_abs = pipe.plan_superbatch(bounds, wms)
    g = gen(lo, smin_abs)
    idx, vals = g if isinstance(g, tuple) else (g, None)
    return idx, vals, plan


def plan_spans(pipe, gen, T, B, slide_ms, n):
    """The first n spans of the stream, staged."""
    return [stage(pipe, gen, i * T, T, B, slide_ms) for i in range(n)]


# ---------------------------------------------------------------------------
# phases 4/5: a pipelined stream through a pipeline, checked by replay
# ---------------------------------------------------------------------------

def run_stream(pipe, gen, T, B, spans, depth, slide_ms, row_of):
    """plan_superbatch + on-card generator + process_superbatch(defer=True),
    `depth` dispatches in flight; returns (fired {j: row}, seconds)."""
    def enqueue(i):
        staged = stage(pipe, gen, i * T, T, B, slide_ms)
        return pipe.process_superbatch(None, None, staged=staged, defer=True)

    fired = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inflight = [enqueue(i) for i in range(min(depth, spans))]
    nxt = len(inflight)
    while inflight:
        d = inflight.pop(0)
        for window, counts, fields in d.resolve():
            fired[window.start // slide_ms] = row_of(counts, fields)
        if nxt < spans:
            inflight.append(enqueue(nxt))
            nxt += 1
    torch.cuda.synchronize()
    return fired, time.perf_counter() - t0


def drive(p, spans=None, depth=None):
    """One pipelined run of path p (see main) from a fresh pipeline."""
    row_of = ((lambda c, f: np.array([f["max"]])) if p["agg"] == "max"
              else (lambda c, f: c))
    return run_stream(p["make"](), p["gen"], p["T"], p["B"], spans or p["spans"],
                      depth or p["depth"], p["slide"], row_of)


def profile_run(name: str, run, groups=(("k1", "k1_"),)) -> dict:
    """Device time by kernel for one run() (which returns its wall seconds)
    under torch.profiler, the share of the run's wall time the device was
    busy, and each group's (label, kernel-name substring) device time and
    share of that busy time (by default K1's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        secs = run()
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key[:70], e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    out = {"phase": "profile", "path": name, "wall_s": secs,
           "device_busy_us": busy_us, "device_busy_share": busy_us / 1e6 / secs}
    rest = busy_us
    for label, sub in groups:
        us = sum(us for us, n, _c in rows if sub in n)
        out[f"{label}_device_us"] = us
        out[f"{label}_share_of_busy"] = us / max(busy_us, 1e-9)
        rest -= us
    # everything else: the on-card generator and torch's own kernels
    out["rest_device_us"] = rest
    out["top"] = [{"name": n, "device_us": us, "calls": c} for us, n, c in rows[:10]]
    return out


def profile_path(p) -> dict:
    return profile_run(p["name"], lambda: drive(p)[1])


def host_profile(name: str, run, top: int = 12) -> dict:
    """Host time by function for one run() under cProfile (a separate run:
    the host-bound paths' wall is Python and numpy): each function's own
    time, largest first."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    secs = run()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{fn[2]} ({fn[0].split('/')[-1]}:{fn[1]})", nc)
                   for fn, (_cc, nc, tt, _ct, _callers) in stats.items()), reverse=True)
    return {"phase": "host_profile", "path": name, "wall_s": secs,
            "top": [{"name": n, "own_s": tt, "calls": c} for tt, n, c in rows[:top]]}


# ---------------------------------------------------------------------------
# the api_ysb phase: YSB written as a DataStream job, through the port's
# API, planner, runners and operator, on both routes
# ---------------------------------------------------------------------------

def _t_filter(col):
    return col[:, 1] < 0.5                 # event_type 0: one record in three


def _t_filter_all(col):
    return col[:, 1] < 2.5                 # skew_matrix_microbench's: every record


def _t_key(col):
    return col[:, 0].to(torch.int32)


def _t_value(col):
    return col[:, 2]


def rows_sink():
    """A sink that keeps each batch it is given, with its timestamps (a
    window's max timestamp): `.batches`."""
    from flink_tpu_torch.connectors.sink import Sink, SinkWriter

    class Writer(SinkWriter):
        def __init__(self, batches):
            self.batches = batches

        def write_batch(self, values, timestamps=None):
            self.batches.append((values, timestamps))

    class RowsSink(Sink):
        def __init__(self):
            self.batches = []

        def create_writer(self):
            return Writer(self.batches)

    return RowsSink()


def api_job(n: int, fused: bool, *, columnar: bool, sum_job: bool = False, dev=DEV,
            hook=None):
    """(env, sink) of the YSB DataStream program over n records: a
    traceable filter and key (one UDF object for both routes), a 10 s
    window sliding by 1 s and `count` — or, with sum_job, a tumbling sum
    whose traceable value_fn feeds K1's add field. The sink keeps each
    batch's records with their timestamps (a window's max timestamp).
    hook(idx) runs before each source batch (gates), if given."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        if hook is not None:
            hook(idx)
        return Batch(*st.api_columns(idx, n, API["keys"], payload=sum_job))

    cfg = Configuration()
    cfg.set(ExecutionOptions.CHAIN_FUSION, fused)
    cfg.set(ExecutionOptions.BATCH_SIZE, API["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, API["keys"])
    cfg.set(ExecutionOptions.COLUMNAR_OUTPUT, columnar)
    env = StreamExecutionEnvironment(cfg, device=dev)
    keyed = (env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True))
    sink = rows_sink()
    if sum_job:
        win = keyed.window(TumblingEventTimeWindows.of(API["sum_window"]))
        win.aggregate("sum", value_fn=_t_value, value_traceable=True).sink_to(sink)
    else:
        win = keyed.window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
        win.aggregate("count").sink_to(sink)
    return env, sink


def k1_dispatch_inputs(window, agg, prologue, n: int, B: int, payload: bool, dev=DEV):
    """K1's inputs of a job's first full dispatch on the fused route (32
    steps of B records of the n-record api stream), made by the pipeline's
    own staging and prologue at the operator's geometry
    (FusedWindowOperator's defaults, chunk 4096): (pipe, idx, vals, plan)."""
    from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
    from flink_tpu_torch.testing import stream as st

    T = 32
    pipe = FusedWindowPipeline(window, agg, key_capacity=API["keys"], nsb=4,
                               fires_per_step=4, out_rows=256, chunk=4096,
                               prologue=prologue, device=dev)
    steps, wms = [], []
    for t in range(T):
        col, ts = st.api_columns(np.arange(t * B, (t + 1) * B, dtype=np.int64), n,
                                 API["keys"], payload=payload)
        steps.append((col, ts))
        wms.append(int(ts.max()) - 1)
    raw, srel, ts, plan = pipe.stage_superbatch_raw(steps, wms)
    idx, vals, _bounds = pipe._run_prologue(raw, srel, ts)
    return pipe, idx, vals, plan


def api_k1_inputs(sum_job: bool, dev=DEV):
    """K1's inputs of the api_ysb job's first full dispatch (32 steps of
    65536 records of a 2^24-record stream): (pipe, agg, idx, vals, plan)."""
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue

    if sum_job:
        window = TumblingEventTimeWindows.of(API["sum_window"])
        prologue = TracedPrologue((("filter", _t_filter),), _t_key, _t_value)
    else:
        window = SlidingEventTimeWindows.of(API["window"], API["slide"])
        prologue = TracedPrologue((("filter", _t_filter),), _t_key)
    agg = resolve("sum" if sum_job else "count")
    pipe, idx, vals, plan = k1_dispatch_inputs(window, agg, prologue, API["fused_events"],
                                               API["batch"], sum_job, dev)
    return pipe, agg, idx, vals, plan


def api_run(n: int, fused: bool, *, columnar: bool, sum_job: bool = False, dev=DEV):
    """One execute() with the launch counts at 0 just before it: (sink,
    seconds, K1 dispatches it made)."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    env, sink = api_job(n, fused, columnar=columnar, sum_job=sum_job, dev=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return sink, secs, cs.LAUNCHES["k1_superscan"]


def api_fired(sink, window_ms: int, slide_ms: int) -> dict:
    """Row-mode sink records as {window index: row over the keys}."""
    fired = {}
    for values, ts in sink.batches:
        for (k, v), t in zip(values, ts):
            j = (int(t) + 1 - window_ms) // slide_ms
            row = fired.get(j)
            if row is None:
                row = fired[j] = np.zeros(API["keys"])
            row[k] = v
    return fired


def api_parity(n: int, *, sum_job: bool, dev=DEV) -> dict:
    """The job in row mode on both routes and the numpy oracle over the same
    columns: window-by-window equality, three ways."""
    from flink_tpu_torch.testing import stream as st

    window_ms = API["sum_window"] if sum_job else API["window"]
    slide_ms = API["sum_window"] if sum_job else API["slide"]
    ref = st.api_replay(n, API["batch"], window_ms=window_ms, slide_ms=slide_ms,
                        agg="sum" if sum_job else "count", num_keys=API["keys"])
    out = {"events": n, "job": "tumbling_sum" if sum_job else "sliding_count"}
    ok = True
    for route, fused in (("fused", True), ("chain", False)):
        sink, secs, launches = api_run(n, fused, columnar=False, sum_job=sum_job, dev=dev)
        fired = api_fired(sink, window_ms, slide_ms)
        route_ok, checked = st.parity(ref.fired, fired, require_all=True)
        route_ok = route_ok and set(fired) <= set(ref.fired)
        out[route] = {"parity": route_ok, "windows_checked": checked,
                      "k1_dispatches": launches, "seconds": secs}
        ok = ok and route_ok
    out["parity"] = ok
    return out


def _dispatched(result: dict) -> bool:
    """Every route of a parity or timed result made K1 dispatches."""
    return all(result[route]["k1_dispatches"] > 0 for route in ("fused", "chain"))


def api_ysb_phase(dev=DEV, sizes=API) -> dict:
    """Parity at sizes["parity_events"] (sliding count and tumbling sum),
    then the timed columnar runs: sizes["fused_events"] records through the
    fused device chain and sizes["chain_events"] through the host chain,
    best of sizes["runs"] each after a warm-up."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    env, _sink = api_job(sizes["warmup_events"], True, columnar=True, dev=dev)
    runners, _feeds = build_runners(plan(env._sinks), env.config, dev)
    fused_selected = any(type(r).__name__ == "DeviceChainRunner" for r in runners)

    count_parity = api_parity(sizes["parity_events"], sum_job=False, dev=dev)
    sum_parity = api_parity(sizes["parity_events"], sum_job=True, dev=dev)
    timed = {}
    for route, fused, n in (("fused", True, sizes["fused_events"]),
                            ("chain", False, sizes["chain_events"])):
        api_run(sizes["warmup_events"], fused, columnar=True, dev=dev)
        runs = [api_run(n, fused, columnar=True, dev=dev) for _ in range(sizes["runs"])]
        secs = min(r[1] for r in runs)
        timed[route] = {"events": n, "tuples_per_s": n / secs, "seconds": secs,
                        "all_seconds": [r[1] for r in runs],
                        "k1_dispatches": runs[0][2],
                        "windows_emitted": sum(len(v) for v, _t in runs[0][0].batches)}
    parity = count_parity["parity"] and sum_parity["parity"]
    dispatched = all(_dispatched(r) for r in (count_parity, sum_parity, timed))
    return {"phase": "api_ysb", "ok": fused_selected and parity and dispatched,
            "k1_dispatched_on_every_route": dispatched, "fused_selected": fused_selected,
            "fused_tuples_per_s": timed["fused"]["tuples_per_s"],
            "chain_tuples_per_s": timed["chain"]["tuples_per_s"],
            "timed": timed, "parity": parity,
            "windows_checked": count_parity["fused"]["windows_checked"],
            "sliding_count": count_parity, "tumbling_sum": sum_parity}


def k1_at_dispatch(label: str, pipe, agg, idx, vals, plan, R=None, plain_reps=(2, 3),
                   rings=None) -> dict:
    """K1 against its plain version on one dispatch's inputs (bit-equal),
    with its time (CUDA events), the plain version's, one index_add_ of the
    dispatch's ingest as the library yardstick, its bound and its device
    time by kernel. R: the fire rows to allocate (a readback group's;
    default the pipeline's); plain_reps: cuda_ms's (reps, rounds) for the
    plain version; rings: the (count, states) the dispatch found (a
    restored or patched ring; default fresh rings)."""
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops.superscan import keyed_superscan_plain
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    S_, K_, T_ = pipe.S, pipe.K, int(plan[0].shape[0])
    R = pipe.R if R is None else R
    kw = dict(NSB=pipe.NSB, R=R, spws=pipe.slot_spws(), exact=True)
    err = compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg,
                         [(idx, vals, plan)], (S_, K_), False, rings=rings, **kw)
    count, states = _ring_copies(agg, (S_, K_), False, rings)
    # K1 as the main path launches it (phase counters on), and off
    timed = on_off_ms(lambda ph: cs.keyed_superscan(agg, count, states, idx, vals, plan[:5],
                                                    phase=ph, **kw))
    plain_ms = cuda_ms(lambda: keyed_superscan_plain(agg, count, states, idx, vals,
                                                     plan[:5], phase=_phase(), **kw),
                       *plain_reps)
    # yardstick: the dispatch's ingest as one index_add_
    ii = idx.view(T_, -1).long()
    live = ii >= 0
    cells = (((plan[0].long()[:, None] + ii % pipe.NSB) % S_) * K_ + ii // pipe.NSB)[live]
    target = (states[0] if states else count).view(-1)
    if vals is not None and not target.is_floating_point():
        # an int add field's sum is a float32 partial before its cast
        target = torch.zeros(target.numel(), dtype=torch.float32, device=target.device)
    src = (vals.view(T_, -1)[live] if vals is not None
           else torch.ones_like(cells, dtype=torch.int32))
    lib_ms = cuda_ms(lambda: target.index_add_(0, cells, src), 10)
    # outputs: the rows the dispatch fires, one per fire (not all R); the
    # package's own count (cs.k1_cost), which the device plane's roofline
    # reads too
    cost = cs.k1_cost(T=T_, B=idx.numel() // T_, K=K_, S=S_, F=pipe.F, nf=len(states),
                      fires=len(plan[5]), records=int(live.sum()))
    b_ms, b_by = bound(cost["bytes_accessed"], cost["flops"])
    return {"shape": f"{label}, T={T_} B={idx.numel() // T_} K={K_} S={S_} R={R} F={pipe.F}",
            **timed, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "fires": len(plan[5]), "device_us": device_split_us(
                lambda: cs.keyed_superscan(agg, count, states, idx, vals, plan[:5],
                                           phase=_phase(), **kw))}


class K1Tap:
    """Installed around cuda_superscan.keyed_superscan for one run: keeps the
    inputs of the first dispatch for which `when()` is true (`first`) and of
    the first of the widest such dispatches (`taken`, the most steps), each
    with copies of the rings it found (a restored or patched ring), for K1's
    check against its plain version. It launches nothing itself."""

    def __init__(self, when=lambda: True):
        self.when, self.first, self.taken, self._real = when, None, None, None

    def __enter__(self):
        from flink_tpu_torch.ops import cuda_superscan as cs

        real = self._real = cs.keyed_superscan

        def tapped(agg, count, states, idx, vals, plan, **kw):
            if self.when():
                wide = self.taken is None or plan[0].shape[0] > self.taken[4][0].shape[0]
                if self.first is None or wide:
                    kept = (agg, (count.clone(), [x.clone() for x in states]), idx.clone(),
                            None if vals is None else vals.clone(),
                            tuple(p.clone() for p in plan))
                    self.first = self.first or kept
                    self.taken = kept if wide else self.taken
            return real(agg, count, states, idx, vals, plan, **kw)

        cs.keyed_superscan = tapped
        return self

    def __exit__(self, *exc):
        from flink_tpu_torch.ops import cuda_superscan as cs

        cs.keyed_superscan = self._real
        return False

    @staticmethod
    def plan(plan5) -> tuple:
        """A kept dispatch's plan with its planned fires' slots (fire_valid
        marks each)."""
        return plan5 + ([None] * int(plan5[2].sum()),)

    @staticmethod
    def _err(kept, pipe) -> float:
        from flink_tpu_torch.ops import cuda_superscan as cs
        from flink_tpu_torch.ops.superscan import keyed_superscan_plain

        agg, rings, idx, vals, plan5 = kept
        return compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg,
                              [(idx, vals, plan5)], (pipe.S, pipe.K), False, rings=rings,
                              NSB=pipe.NSB, R=pipe.R, spws=pipe.slot_spws(), exact=True)

    def _first(self, label: str, pipe) -> dict:
        if self.taken is None:
            raise AssertionError(f"{label}: the run made no dispatch to hold K1 against")
        return {"steps": int(self.first[4][0].shape[0]),
                "max_abs_err": self._err(self.first, pipe)}

    def exact(self, label: str, pipe) -> dict:
        """K1 against its plain version, bit for bit, at the widest and at
        the first dispatch (`first_dispatch`), each from the rings it found
        (the first's a restored or patched ring as loaded); no timing, no
        profiler."""
        return {"first_dispatch": self._first(label, pipe),
                "max_abs_err": self._err(self.taken, pipe)}

    def check(self, label: str, pipe) -> dict:
        """`exact`'s check, with the widest dispatch reported as
        k1_at_dispatch reports it (times, bound, device split)."""
        first = self._first(label, pipe)
        agg, rings, idx, vals, plan5 = self.taken
        out = k1_at_dispatch(label, pipe, agg, idx, vals, self.plan(plan5), rings=rings)
        return dict(out, first_dispatch=first)


# ---------------------------------------------------------------------------
# the session phases: bench.py::secondary_sessions' stream through the
# session operator (kernels K3 and K4), and a session DataStream job
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def session_op(dev, sizes, defer=True):
    from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
    from flink_tpu_torch.runtime.tpu_session_operator import TpuSessionWindowOperator

    return TpuSessionWindowOperator(EventTimeSessionWindows.with_gap(sizes["gap"]), "sum",
                                    key_capacity=sizes["K"], num_slices=sizes["S"],
                                    defer_emissions=defer, device=dev)


def session_plan(lo: int, sizes):
    """Step bounds and merge watermarks of the superspan at step lo: a merge
    every merge_every steps at (t+1)*655 - 1000."""
    from flink_tpu_torch.testing import stream as st

    T = sizes["T"]
    bounds = [st.session_step_bounds(lo + r, sizes["B"], sizes["gap"]) for r in range(T)]
    wms = [st.watermark_after(lo + r) if (r + 1) % sizes["merge_every"] == 0 else None
           for r in range(T)]
    return bounds, wms


def run_sessions(gen, dev, sizes, spans: int, per_step: bool = False):
    """`spans` superspans of the session stream (made on `dev` by gen) through
    a fresh operator, fused (process_superspan_staged, deferred) or per step
    (process_batch_staged + process_watermark, the replay route), then the
    final watermark 2^60 and the drain: ({(key, start, end): sum}, seconds,
    operator)."""
    op = session_op(dev, sizes, defer=not per_step)
    T = sizes["T"]
    _sync(dev)
    t0 = time.perf_counter()
    for lo in range(0, spans * T, T):
        staged = gen(lo)
        bounds, wms = session_plan(lo, sizes)
        if per_step:
            for t in range(T):
                op.process_batch_staged(*(x[t] for x in staged), *bounds[t])
                if wms[t] is not None:
                    op.process_watermark(wms[t])
        else:
            op.process_superspan_staged(*staged, bounds, wms)
    op.process_watermark(1 << 60)
    out = op.drain_output()          # the operator's rows, as the bench takes them
    _sync(dev)
    secs = time.perf_counter() - t0
    return {(int(k), w.start, w.end): float(r) for k, w, r, _t in out}, secs, op


def sessions_match(got: dict, expect: dict) -> bool:
    """The same (key, start, end) set, sums within the bench's 1e-3 relative
    tolerance."""
    return (len(got) > 0 and got.keys() == expect.keys()
            and all(abs(got[k] - expect[k]) <= 1e-3 * max(1.0, abs(expect[k])) for k in got))


def _k3_routes(launches) -> dict:
    """K3's launches by route (tiled: k3_ingest_tiled, atomic:
    k3_ingest_atomic), and the second kernel of the tiled launches whose
    tiles split over several clusters (merge_parts: k3_merge_parts)."""
    return {"tiled": launches["k3_session_ingest"],
            "atomic": launches["k3_session_ingest_atomic"],
            "merge_parts": launches["k3_merge_parts"]}


def session_sum_phase(dev=DEV, sizes=None) -> dict:
    """bench.py::secondary_sessions on the port: parity of one superspan (the
    bench's T steps) against numpy_sessionize over the replayed records and
    against the per-step route, then a warm run and the timed run of
    sizes["spans"] superspans with the launch counts at 0 just before it."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or SESSIONS
    T, B = sizes["T"], sizes["B"]
    gen = st.make_session_gen(T, B, device=dev, gap_ms=sizes["gap"], num_slices=sizes["S"])
    cuda_session.reset_launch_counts()
    got, _secs, op = run_sessions(gen, dev, sizes, 1)
    parity_launches = dict(cuda_session.LAUNCHES)
    t_rep = time.perf_counter()
    recs = [np.concatenate(a) for a in zip(*(st.host_session_step(t, B) for t in range(T)))]
    expect = st.numpy_sessionize(*recs, sizes["gap"])
    replay_s = time.perf_counter() - t_rep
    per_step, _s, step_op = run_sessions(gen, dev, sizes, 1, per_step=True)
    parity = sessions_match(got, expect)
    route_parity = per_step == got

    run_sessions(gen, dev, sizes, sizes["spans"])                      # warm
    cuda_session.reset_launch_counts()
    out, secs, op_t = run_sessions(gen, dev, sizes, sizes["spans"])
    launches = dict(cuda_session.LAUNCHES)
    events = sizes["spans"] * T * B
    replays = op.superspan_replays + op_t.superspan_replays + step_op.superspan_replays
    k3 = cuda_session.k3_launches(launches)
    failed = [name for name, good in (
        ("parity_numpy_sessionize", parity), ("route_parity_per_step", route_parity),
        ("superspan_replays_0", replays == 0), ("k3_launched", k3 > 0),
        ("k4_launched", launches["k4_session_merge"] > 0)) if not good]
    return {"phase": "session_sum", "ok": not failed, "failed": failed, "parity": parity,
            "exact": got == expect, "route_parity": route_parity,
            "sessions_checked": len(expect), "tuples_per_s": events / secs, "events": events,
            "seconds": secs, "sessions_emitted": len(out), "dispatches": sizes["spans"],
            "k3_launches": k3, "k3_routes": _k3_routes(launches),
            "k4_launches": launches["k4_session_merge"],
            "k3_per_dispatch": k3 / sizes["spans"],
            # two merges a superspan, plus the final watermark's merge
            "k4_per_dispatch": (launches["k4_session_merge"] - 1) / sizes["spans"],
            "parity_run_launches": parity_launches, "superspan_replays": replays,
            "replay_s": replay_s}


def session_api_job(n: int, sizes, dev=DEV):
    """(env, sink) of the session DataStream job over n records of the
    session stream at sizes["batch"] records a step (one source batch a
    step): columns (user, value) made on the host, watermarks bounded by
    the stream's 500 ms jitter (below the 2000 ms gap, so the session
    operator runs and no record is late), a traceable int32 key and
    `sum` of a traceable value_fn."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import EventTimeSessionWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    batch = sizes["batch"]

    def gen(idx):
        keys, ts, vals = st.session_records(idx, batch)
        return Batch(np.stack([keys, vals], axis=1).astype(np.float32), ts)

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(ExecutionOptions.KEY_CAPACITY, SESSIONS["K"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = rows_sink()
    (env.from_source(DataGeneratorSource(gen, n),
                     WatermarkStrategy.for_bounded_out_of_orderness(st.OOO_MS))
     .key_by(_t_key, traceable=True)
     .window(EventTimeSessionWindows.with_gap(st.SESSION_GAP_MS))
     .aggregate("sum", value_fn=_t_sval, value_traceable=True).sink_to(sink))
    return env, sink


def _t_sval(col):
    return col[:, 1]


def session_api_run(n: int, sizes, dev=DEV):
    """One execute() with the session launch counts at 0 just before it:
    (sink, seconds, launches, the session operators the job made)."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.runtime import tpu_session_operator as tso

    made = []
    init = tso.TpuSessionWindowOperator.__init__

    def recording(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    env, sink = session_api_job(n, sizes, dev)
    _sync(dev)
    cuda_session.reset_launch_counts()
    tso.TpuSessionWindowOperator.__init__ = recording
    try:
        t0 = time.perf_counter()
        env.execute()
        _sync(dev)
        secs = time.perf_counter() - t0
    finally:
        tso.TpuSessionWindowOperator.__init__ = init
    return sink, secs, dict(cuda_session.LAUNCHES), made


def api_sessions_phase(dev=DEV, sizes=None) -> dict:
    """The session DataStream job: parity of its rows against
    numpy_sessionize over the same records (as (key, end): sum, the rows'
    timestamps being each session's end - 1), tuples/s best of
    sizes["runs"] after a warm-up, launches, and the host profile."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or API_SESSIONS
    n = sizes["events"]
    env, _sink = session_api_job(1024, sizes, dev)
    selected = [type(getattr(r, "op", None)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    session_api_run(sizes["batch"] * 8, sizes, dev)                   # warm
    runs = [session_api_run(n, sizes, dev) for _ in range(sizes["runs"])]
    sink, _secs, launches, ops = runs[0]
    replays = sum(o.superspan_replays for r in runs for o in r[3])
    got = {(int(k), int(t) + 1): float(v) for values, ts in sink.batches
           for (k, v), t in zip(values, ts)}
    keys, ts, vals = st.session_records(np.arange(n, dtype=np.int64), sizes["batch"])
    expect = {(k, e): v for (k, _s, e), v in
              st.numpy_sessionize(keys, ts, vals, st.SESSION_GAP_MS).items()}
    rows = sum(len(v) for v, _t in sink.batches)
    parity = sessions_match(got, expect) and rows == len(expect)
    secs = min(r[1] for r in runs)
    failed = [name for name, good in (
        ("parity_numpy_sessionize", parity),
        ("session_operator_selected", "TpuSessionWindowOperator" in selected),
        ("one_session_operator", len(ops) == 1), ("superspan_replays_0", replays == 0),
        ("k3_launched", cuda_session.k3_launches(launches) > 0),
        ("k4_launched", launches["k4_session_merge"] > 0)) if not good]
    return {"phase": "api_sessions", "ok": not failed, "failed": failed, "parity": parity,
            "sessions_checked": len(expect),
            "operator_selected": "TpuSessionWindowOperator" in selected, "events": n,
            "tuples_per_s": n / secs, "seconds": secs, "all_seconds": [r[1] for r in runs],
            "k3_launches": cuda_session.k3_launches(launches), "k3_routes": _k3_routes(launches),
            "k4_launches": launches["k4_session_merge"], "superspan_replays": replays}


def session_kernel_times(card: str, dev=DEV) -> dict:
    """K3 and K4 against their plain versions at the session_sum shapes
    and at api_sessions' step (bit-equal required; a gate that fails is
    named in "failed"), with their times (CUDA events; K4's with the ring
    restored before each call, less the restore alone), device time from
    the profiler, the wrappers' host µs a call (host_us: 200 calls back to
    back, one synchronize after them), bytes bounds from this run's data,
    K3's route and the route it did not take (at k3_step the atomic one,
    at api_sessions' step the tiled one, which K3_TILED_MIN_RECORDS rules
    out there), and for K3 the yardstick of the PyTorch scatter calls its
    plain version makes."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import superscan as ps
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    z = SESSIONS
    K, S, T, B, g = z["K"], z["S"], z["T"], z["B"], z["gap"]
    op = session_op(dev, z)
    vf, idents = op._vfields, op._idents
    kid, spos, rel, vals = st.make_session_gen(T, B, device=dev)(0)
    run = z["merge_every"]
    out = {"phase": "session_kernel_times", "card": card, "failed": []}

    def fresh():
        o = session_op(dev, z)
        return [o._cnt, o._mn, o._mx, list(o._fields)]

    def flat(r):
        return r[:3] + r[3]

    def err_of(name, a, b, extra=()):
        err = 0.0
        for x, y in list(zip(flat(a), flat(b))) + list(extra):
            err = max(err, _max_abs_err(x, y))
            if not torch.equal(x, y) and name not in out["failed"]:
                out["failed"].append(name)
        return err

    def window(t0, t1, b):
        bs = [st.session_step_bounds(t, b) for t in range(t0, t1 + 1)]
        return min(x[0] for x in bs), max(x[1] for x in bs)

    def host_us(fn, calls=200):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        _sync(dev)
        return us

    # K3: one step, one run of `run` steps (one launch each), and one step
    # of api_sessions' 65536 records, each over its slice window
    ab = API_SESSIONS["batch"]
    cases = {"k3_step": ((kid[:1], spos[:1], rel[:1], vals[:1]), window(0, 0, B), "1 step of "
                         "2^20 records"),
             "k3_run": ((kid[:run], spos[:run], rel[:run], vals[:run]), window(0, run - 1, B),
                        f"{run} steps of 2^20 records"),
             "k3_api_step": (st.make_session_gen(1, ab, device=dev)(0), window(0, 0, ab),
                             f"1 step of {ab} records (api_sessions' batch)")}
    for name, (args, win, what) in cases.items():
        a, b = fresh(), fresh()
        cuda_session.reset_launch_counts()
        cuda_session.session_ingest(*a, *args, vf, window=win)
        route = "tiled" if cuda_session.LAUNCHES["k3_session_ingest"] else "atomic"
        ps.session_ingest_plain(*b, *args, vf)
        _sync(dev)
        err = err_of(name, a, b)
        ring = fresh()
        ms = cuda_ms(lambda: cuda_session.session_ingest(*ring, *args, vf, window=win), 10)
        plain_ms = cuda_ms(lambda: ps.session_ingest_plain(*ring, *args, vf), 2, 3)
        cell = (args[1].long() * K + args[0].long()).reshape(-1)
        r, v = args[2].reshape(-1), args[3].reshape(-1)
        ones = torch.ones_like(cell, dtype=torch.int32)
        lib_ms = cuda_ms(lambda: (ring[0].view(-1).index_add_(0, cell, ones),
                                  ring[1].view(-1).scatter_reduce_(0, cell, r, "amin"),
                                  ring[2].view(-1).scatter_reduce_(0, cell, r, "amax"),
                                  ring[3][0].view(-1).index_add_(0, cell, v)), 10)
        n = cell.numel()
        touched = int(torch.unique(cell).numel())
        # records read once (16 B each), each touched cell of the four rings
        # read and written once
        b_ms, b_by = bound(n * 16 + touched * 4 * 4 * 2, n * 4)
        p0, W = cuda_session.k3_window([win], S)
        h = cuda_session._head(*ring, vf, ())
        plan = cuda_session.k3_plan(K, W, len(vf), h.clusters)
        nt, parts, kt = plan if route == "tiled" else (0, 0, 0)
        out[name] = {"shape": f"{what} into [{S}, {K}] (sum), window {W} from {p0}",
                     "route": route, "tiles": nt, "parts": parts,
                     "cluster": cuda_session.K3_CLUSTER if nt else 0, "tile_keys": kt,
                     "records": n, "cells_touched": touched, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err,
                     "device_us": device_split_us(
                         lambda: cuda_session.session_ingest(*ring, *args, vf, window=win)),
                     "host_us": host_us(
                         lambda: cuda_session.session_ingest(*ring, *args, vf, window=win))}
        if name == "k3_api_step" and plan[0]:  # the same step through the tiled route
            recs = [x.contiguous() for x in args]
            ptrs = [x.data_ptr() for x in recs]

            def tiled(r):
                hr = cuda_session._head(*r, vf, ())
                cuda_session._launch_k3(hr, ptrs, n, p0, W, plan, cuda_session._stream(hr.dev))

            a = fresh()
            tiled(a)
            _sync(dev)
            err_of("k3_api_step_tiled", a, b)
            out[name]["tiled_plan"] = list(plan)
            out[name]["tiled_ms"] = cuda_ms(lambda: tiled(ring), 10)
            out[name]["tiled_device_us"] = device_split_us(lambda: tiled(ring))
        if name == "k3_step":                  # the same step through the atomic route
            a = fresh()
            cuda_session.session_ingest(*a, *args, vf)
            _sync(dev)
            err_of("k3_step_atomic", a, b)
            out[name]["atomic_ms"] = cuda_ms(
                lambda: cuda_session.session_ingest(*ring, *args, vf), 10)
            out[name]["atomic_device_us"] = device_split_us(
                lambda: cuda_session.session_ingest(*ring, *args, vf))
        del cell, ones
    # K4 on the ring as the operator holds it at the superspan's second
    # merge (after step T-1; the first closes no session of this stream):
    # superspan mode over the full ring, and per-watermark mode over the
    # resident slice span
    base = fresh()
    cuda_session.session_ingest(*base, kid, spos, rel, vals, vf)
    lo = min(st.session_step_bounds(t, B)[0] for t in range(T))
    hi = max(st.session_step_bounds(t, B)[1] for t in range(T))
    span = hi - lo + 1
    pos_d = torch.from_numpy((np.arange(lo, hi + 1) % S).astype(np.int32)).to(dev)
    wm_rel = st.watermark_after(T - 1) - lo * g
    M_ss = -(-(span + 2 + 2) // 8) * 8           # the operator's rules for M
    M_pw = span + 1
    none = torch.empty((1, 0), dtype=torch.int32, device=dev)
    nonef = none.float()
    modes = {
        "k4_superspan": (lambda r: cuda_session.session_superscan(
            *r, none, none, none, nonef, [1], [lo % S], [0], [wm_rel], g=g, M=M_ss,
            vfields=vf, idents=idents),
                         lambda r: ps.session_superscan_plain(
            *r, none, none, none, nonef, [1], [lo % S], [0], [wm_rel], g=g, M=M_ss,
            vfields=vf, idents=idents), torch.arange(S, device=dev), M_ss),
        "k4_per_watermark": (lambda r: cuda_session.session_merge(
            *r, pos_d, wm_rel, g=g, M=M_pw, vfields=vf, idents=idents),
                             lambda r: ps.session_merge_plain(
            *r, pos_d, None, wm_rel, g=g, M=M_pw, vfields=vf, idents=idents), pos_d.long(),
                             M_pw),
    }
    for name, (kern, plain, scanned, M) in modes.items():
        a, b = fresh(), fresh()
        for x, y, src in zip(flat(a), flat(b), flat(base)):
            x.copy_(src)
            y.copy_(src)
        pa, pb = kern(a), plain(b)
        _sync(dev)
        err = err_of(name, a, b, [(pa, pb)])
        _times, _blocks, slots, _scal = ps.unpack_sessions(pb, K, M, len(vf))
        sessions = int(slots.sum())
        purged = int((flat(base)[0] > 0).sum() - (b[0] > 0).sum())
        occupied = int((flat(base)[0][scanned] > 0).sum())
        ring = fresh()

        def restore():
            for x, src in zip(flat(ring), flat(base)):
                x.copy_(src)

        restore_ms = cuda_ms(restore, 10)
        ms = cuda_ms(lambda: (restore(), kern(ring)), 10) - restore_ms
        plain_ms = cuda_ms(lambda: (restore(), plain(ring)), 2, 3) - restore_ms
        nf = len(vf)
        cols = int(scanned.numel())
        # what the merge must move, from this run's ring: the count ring over
        # the scanned columns; min, max and the fields at the occupied cells
        # there; the purged cells written back; every slot of the packed
        # result (int64 start and end, count, fields: the kernel writes the
        # unused ones' zeros too) and each key's slot count (both merges here
        # are a result's first, which writes the counts and reads none).
        # bound_ms_sessions_only counts only the closed sessions' slots, as
        # when a wrapper zero-filled the rest
        ring_bytes = cols * K * 4 + occupied * 4 * (2 + nf) + purged * 4 * (3 + nf) + K * 4
        nbytes = ring_bytes + M * K * (16 + 4 * (1 + nf))
        b_ms, b_by = bound(nbytes, cols * K * 8)
        b_old = bound(ring_bytes + sessions * (16 + 4 * (1 + nf)), cols * K * 8)[0]
        out[name] = {"shape": f"{name.split('_', 1)[1]} merge of {cols} columns of [{S}, {K}] "
                              f"(sum), M={M}",
                     "sessions": sessions, "cells_occupied": occupied, "cells_purged": purged,
                     "bound_bytes": nbytes, "ms": ms,
                     "plain_ms": plain_ms, "restore_ms": restore_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_ms_sessions_only": b_old,
                     "max_abs_err": err,
                     "device_us": device_split_us(lambda: (restore(), kern(ring))),
                     "host_us": host_us(lambda: kern(ring))}
    return out


# ---------------------------------------------------------------------------
# the per-batch phases (phases 12-16): the per-batch window operator with
# allowed lateness and a late side output, its DataStream job, the
# count-triggered global window and the continuous aggregate. Their device
# programs are torch programs, not kernels: they go on their own line.
# ---------------------------------------------------------------------------

def lateness_op(dev, sizes, kernel="scatter"):
    """TpuWindowOperator as the lateness_operator phase drives it: 10 s
    windows sliding by 1 s, `sum`, columnar output, dense int keys below K,
    and the operator's own ring rule (S = 64 at 2 s of lateness)."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
    from flink_tpu_torch.testing import stream as st

    return TpuWindowOperator(SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS), "sum",
                             allowed_lateness=sizes["lateness"], emit_late_to_side_output=True,
                             columnar_output=True, dense_int_keys=True,
                             key_capacity=sizes["K"], ingest_kernel=kernel, device=dev)


def lateness_batches(sizes):
    """The lateness stream's batches, made on the host (set-up): (keys,
    values, timestamps, the watermark after the batch), the watermark
    trailing the largest timestamp so far by LATE_WM_LAG_MS."""
    from flink_tpu_torch.testing import stream as st

    K, B = sizes["K"], sizes["B"]
    out, top = [], None
    for b in range(sizes["warm"] + sizes["timed"]):
        keys, ts, vals = st.late_records(np.arange(b * B, (b + 1) * B, dtype=np.int64), B, K)
        top = int(ts.max()) if top is None else max(top, int(ts.max()))
        out.append((keys, vals, ts, top - st.LATE_WM_LAG_MS))
    return out


def run_lateness(op, batches, dev):
    """Each batch through the operator: ingest, watermark, drain. Returns
    ([(window start, key ids, values)] a fire or re-fire, seconds)."""
    events = []
    _sync(dev)
    t0 = time.perf_counter()
    for keys, vals, ts, wm in batches:
        op.process_batch(keys, vals, ts)
        op.process_watermark(wm)
        events += [(w.start, ids, v) for _k, w, (ids, v), _t in op.drain_output()]
    _sync(dev)
    return events, time.perf_counter() - t0


def lateness_matches(events, op, want, side) -> bool:
    """Every emission equals the oracle's, in order (window, ascending key
    ids, values), and the side output is the oracle's too-late set."""
    from flink_tpu_torch.testing import stream as st

    same = len(events) == len(want) and all(
        ws == j * st.SLIDE_MS and np.array_equal(ids, ks)
        and np.array_equal(np.asarray(v, np.float64), vs)
        for (ws, ids, v), (_kind, j, ks, vs) in zip(events, want))
    got = sorted((int(k), float(v), int(t)) for k, v, t in op.side_output.get("late-data", []))
    expect = sorted(zip(np.concatenate([s[0] for s in side]).tolist(),
                        np.concatenate([s[1] for s in side]).tolist(),
                        np.concatenate([s[2] for s in side]).tolist()))
    return same and got == expect and len(expect) > 0


def lateness_operator_phase(dev=DEV, sizes=None) -> dict:
    """TpuWindowOperator driven directly at 2^20 keys (a count and a sum ring
    of [64, 2^20] on the card, 256 MiB each): 2 warm-up batches, then 16
    timed, 2^20 records each, with the program calls at 0 just before the
    timed batches; then the same with the sort-based ingest. Every emission
    and the side output are held against LatenessOracle."""
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or LATENESS
    batches = lateness_batches(sizes)
    t_or = time.perf_counter()
    orc = st.LatenessOracle(st.WINDOW_MS, st.SLIDE_MS, sizes["lateness"], sizes["K"])
    want, side = [], []
    for keys, vals, ts, wm in batches:
        events, late = orc.step(keys, ts, vals, wm)
        want += events
        side.append(late)
    oracle_s = time.perf_counter() - t_or
    out = {"phase": "lateness_operator", "keys": sizes["K"], "batch": sizes["B"],
           "timed_batches": sizes["timed"], "oracle_s": oracle_s,
           "windows_checked": sum(e[0] == "fire" for e in want),
           "refires_checked": sum(e[0] == "refire" for e in want),
           "side_output_checked": int(sum(len(s[0]) for s in side))}
    ok = True
    runs = {}
    for kernel in ("scatter", "sort"):
        op = lateness_op(dev, sizes, kernel)
        events, _s = run_lateness(op, batches[:sizes["warm"]], dev)
        so.reset_call_counts()
        timed, secs = run_lateness(op, batches[sizes["warm"]:], dev)
        calls = {k: v for k, v in so.CALLS.items() if v}
        events += timed
        parity = lateness_matches(events, op, want, side)
        runs[kernel] = events
        ring_mib = {name: t.numel() * t.element_size() / 2**20
                    for name, t in [("count", op.state.count)] + list(op.state.acc.items())}
        out[kernel] = {"parity": parity, "tuples_per_s": sizes["timed"] * sizes["B"] / secs,
                       "seconds": secs, "S": op.S, "ring_mib": ring_mib, "program_calls": calls,
                       "emissions": len(events)}
        ok = ok and parity and op.S == 64 and (calls.get("ingest", 0) or calls.get("ingest_sort", 0))
        del op
    same = len(runs["scatter"]) == len(runs["sort"]) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        for a, b in zip(runs["scatter"], runs["sort"]))
    out["ingest_forms_agree"] = same
    out["tuples_per_s"] = out["scatter"]["tuples_per_s"]
    if torch.device(dev).type == "cuda":
        prof = profile_run("lateness_operator", lambda: run_lateness(
            lateness_op(dev, sizes), batches, dev)[1], groups=())
        out["device_busy_share"] = prof["device_busy_share"]
        out["profile"] = prof
    out["ok"] = bool(ok and same)
    return out


def by_window(rows):
    """(timestamp, key, value) rows cut into fire events (runs of one
    window timestamp), each sorted: within a fire the operator emits in
    key-dictionary order."""
    out, run = [], []
    for r in rows:
        if run and r[0] != run[-1][0]:
            out.append(sorted(run))
            run = []
        run.append(r)
    return out + ([sorted(run)] if run else [])


def api_lateness_job(n: int, sizes, dev=DEV):
    """(env, sink, late sink) of the api_ysb program with
    allowed_lateness(2000).side_output_late_data() over the lateness
    stream's columns, for_bounded_out_of_orderness(500), and a
    get_side_output(LATE_DATA_TAG) sink."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import LATE_DATA_TAG
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    batch, keys = sizes["batch"], sizes["keys"]
    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, batch)
    cfg.set(ExecutionOptions.KEY_CAPACITY, keys)
    env = StreamExecutionEnvironment(cfg, device=dev)
    counted = (env.from_source(
        DataGeneratorSource(lambda idx: Batch(*st.late_columns(idx, batch, keys)), n),
        WatermarkStrategy.for_bounded_out_of_orderness(st.LATE_WM_LAG_MS))
        .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
        .window(SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS))
        .allowed_lateness(sizes["lateness"]).side_output_late_data().count())
    sink, late = rows_sink(), rows_sink()
    counted.sink_to(sink)
    counted.get_side_output(LATE_DATA_TAG).sink_to(late)
    return env, sink, late


def api_lateness_oracle(n: int, sizes):
    """The oracle over the job's filtered records, batch by batch with the
    source's watermarks: (rows (window max timestamp, key, count) in
    emission order, too-late (key, ts) sorted)."""
    from flink_tpu_torch.testing import stream as st

    batch, keys = sizes["batch"], sizes["keys"]
    orc = st.LatenessOracle(st.WINDOW_MS, st.SLIDE_MS, sizes["lateness"], keys, agg="count")
    rows, side, wm = [], [], None

    def add(events):
        rows.extend((j * st.SLIDE_MS + st.WINDOW_MS - 1, int(k), int(v))
                    for _kind, j, ks, vs in events for k, v in zip(ks, vs))

    for lo in range(0, n, batch):
        col, ts = st.late_columns(np.arange(lo, min(lo + batch, n), dtype=np.int64), batch, keys)
        top = int(ts.max()) - st.LATE_WM_LAG_MS - 1
        wm = top if wm is None else max(wm, top)
        keep = col[:, 1] == 0
        events, late = orc.step(col[keep, 0].astype(np.int64), ts[keep], col[keep, 2], wm)
        add(events)
        side += zip(late[0].tolist(), late[2].tolist())
    add(orc.advance(2**62))
    return rows, sorted(side)


def timed_execute(env, dev) -> float:
    """Seconds of one env.execute(), the device drained on both sides."""
    _sync(dev)
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    return time.perf_counter() - t0


def api_lateness_run(sizes, dev=DEV) -> float:
    """One execute() of the job at sizes["events"] records: seconds."""
    return timed_execute(api_lateness_job(sizes["events"], sizes, dev)[0], dev)


def api_lateness_phase(dev=DEV, sizes=None) -> dict:
    """The job at sizes["events"] records in row mode: TpuWindowOperator
    selected, every fire (re-fires included) and the side output equal the
    oracle's; tuples/s of the checked run after a warm-up run."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.runtime.executor import build_runners

    sizes = sizes or API_LATENESS
    n = sizes["events"]
    env, _s, _l = api_lateness_job(1024, sizes, dev)
    selected = [type(getattr(r, "op", r)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    env, _s, _l = api_lateness_job(sizes["batch"] * 16, sizes, dev)
    env.execute()                                                      # warm
    env, sink, late = api_lateness_job(n, sizes, dev)
    so.reset_call_counts()
    secs = timed_execute(env, dev)
    calls = {k: v for k, v in so.CALLS.items() if v}
    got = [(int(t), int(k), int(v)) for values, ts in sink.batches
           for (k, v), t in zip(values, ts)]
    got_late = sorted((int(k), int(t)) for values, ts in late.batches
                      for (k, _v), t in zip(values, ts))
    t_or = time.perf_counter()
    want, want_late = api_lateness_oracle(n, sizes)
    oracle_s = time.perf_counter() - t_or
    parity = by_window(got) == by_window(want) and len(got) > 0
    side_parity = got_late == want_late and len(want_late) > 0
    refires = len(want) - len({(t, k) for t, k, _v in want})
    ok = parity and side_parity and "TpuWindowOperator" in selected and calls.get("ingest", 0) > 0
    return {"phase": "api_lateness", "ok": ok, "parity": parity, "side_output_parity": side_parity,
            "operator_selected": "TpuWindowOperator" in selected, "runners": selected,
            "events": n, "tuples_per_s": n / secs, "seconds": secs, "rows_checked": len(want),
            "refired_rows": refires, "side_output_checked": len(want_late),
            "program_calls": calls, "oracle_s": oracle_s}


def count_columns(idx: np.ndarray, sizes):
    """(key, value) float32 columns and in-order timestamps of records idx:
    30% of records on `hot_keys` keys, the rest over all keys; values are
    integers below 8."""
    from flink_tpu_torch.testing import stream as st

    bits = st.hash_bits(st.step_key(st.SEED + 13, 0), idx)
    hot = (bits >> 20) % 10 < 3
    keys = np.where(hot, bits % sizes["hot_keys"], (bits >> 4) % sizes["keys"])
    return np.stack([keys, (bits >> 24) & 7], axis=1).astype(np.float32), idx.astype(np.int64)


def _t_col1(col):
    return col[:, 1]


def api_count_job(n: int, purging: bool, sizes, dev=DEV):
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import GlobalWindows
    from flink_tpu_torch.api.windowing.triggers import CountTrigger, PurgingTrigger
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sizes["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, sizes["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    trigger = CountTrigger.of(sizes["n"])
    sink = rows_sink()
    (env.from_source(DataGeneratorSource(lambda idx: Batch(*count_columns(idx, sizes)), n),
                     WatermarkStrategy.for_monotonous_timestamps())
     .key_by(_t_key, traceable=True).window(GlobalWindows.create())
     .trigger(PurgingTrigger.of(trigger) if purging else trigger)
     .aggregate("sum", value_fn=_t_col1, value_traceable=True).sink_to(sink))
    return env, sink


def count_model(n: int, purging: bool, sizes):
    """Numpy model of the per-batch coalesced count rule: after each
    batch's ingest a key fires once if its count reached N (purging: then
    resets) or crossed a new multiple of N (non-purging). Returns each
    firing batch's sorted (key, sum) rows."""
    keys_n, n_fire = sizes["keys"], sizes["n"]
    acc = np.zeros(keys_n)
    cnt = np.zeros(keys_n, np.int64)
    fired = np.zeros(keys_n, np.int64)
    out = []
    for lo in range(0, n, sizes["batch"]):
        col, _ts = count_columns(np.arange(lo, min(lo + sizes["batch"], n), dtype=np.int64), sizes)
        k = col[:, 0].astype(np.int64)
        acc += np.bincount(k, weights=col[:, 1], minlength=keys_n)
        cnt += np.bincount(k, minlength=keys_n)
        fire = cnt >= n_fire if purging else cnt // n_fire > fired // n_fire
        hit = np.flatnonzero(fire)
        if hit.size:
            out.append(sorted(zip(hit.tolist(), acc[hit].tolist())))
        if purging:
            acc[fire], cnt[fire] = 0.0, 0
        else:
            fired[fire] = cnt[fire]
    return out


def api_count_window_phase(dev=DEV, sizes=None) -> dict:
    """GlobalWindows with PurgingTrigger.of(CountTrigger.of(64)) at
    sizes["events"] records, then a non-purging CountTrigger at
    sizes["nonpurging_events"]: TpuGlobalWindowOperator selected, its step
    called once a batch, every firing batch equal to the model's."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime import tpu_global_window_operator as gw
    from flink_tpu_torch.runtime.executor import build_runners

    sizes = sizes or API_COUNT
    env, _sink = api_count_job(1024, True, sizes, dev)
    selected = [type(getattr(r, "op", r)).__name__
                for r in build_runners(plan(env._sinks), env.config, dev)[0]]
    out = {"phase": "api_count_window", "operator_selected": "TpuGlobalWindowOperator" in selected,
           "count_n": sizes["n"], "keys": sizes["keys"]}
    ok = out["operator_selected"]
    for name, purging, n in (("purging", True, sizes["events"]),
                             ("nonpurging", False, sizes["nonpurging_events"])):
        env, sink = api_count_job(n, purging, sizes, dev)
        gw.CALLS["global_count_step"] = 0
        secs = timed_execute(env, dev)
        steps = gw.CALLS["global_count_step"]
        got = [sorted((int(k), float(v)) for k, v in values) for values, _ts in sink.batches]
        want = count_model(n, purging, sizes)
        parity = got == want and len(want) > 0
        out[name] = {"parity": parity, "events": n, "tuples_per_s": n / secs, "seconds": secs,
                     "fires": sum(len(w) for w in want), "firing_batches": len(want),
                     "steps": steps}
        ok = ok and parity and steps == -(-n // sizes["batch"])
    out["ok"] = ok
    return out


def api_group_agg_run(rows, device: bool, sizes, dev=DEV):
    """continuous_aggregate of COUNT(*), SUM(v) and AVG(v) by key over
    `rows`, mini-batch on: (changelog, seconds, runner kinds)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sizes["batch"])
    cfg.set(ExecutionOptions.DEVICE_GROUP_AGG, device)
    cfg.set(ExecutionOptions.MINI_BATCH_GROUP_AGG, True)
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = (env.from_collection(rows).key_by(lambda r: r["k"])
            .continuous_aggregate([("COUNT", None), ("SUM", "v"), ("AVG", "v")], ["k"],
                                  ["c", "s", "a"]).collect())
    runners = build_runners(plan(env._sinks), env.config, dev)[0]
    kinds = [(type(r).__name__, getattr(r, "device", None)) for r in runners]
    return sink.results, timed_execute(env, dev), kinds


def api_group_agg_phase(dev=DEV, sizes=None) -> dict:
    """The continuous aggregate with execution.group-agg.device=true over
    sizes["rows"] changelog rows (10% retractions, made on the host):
    GroupAggRunner on its device path, one step a batch, the changelog equal
    to the host path's on the same rows (kinds, keys, COUNT and SUM exact,
    AVG to rtol 1e-6)."""
    from flink_tpu_torch.runtime import group_agg_operator as ga
    from flink_tpu_torch.table.changelog import ROW_KIND_FIELD
    from flink_tpu_torch.testing import stream as st

    sizes = sizes or API_GROUP_AGG
    rows = st.changelog_rows(sizes["rows"], sizes["keys"], sizes["retract"])
    api_group_agg_run(rows[:sizes["batch"]], True, sizes, dev)          # warm
    ga.CALLS["group_agg_step"] = 0
    got, secs, kinds = api_group_agg_run(rows, True, sizes, dev)
    steps = ga.CALLS["group_agg_step"]
    host, host_s, _k = api_group_agg_run(rows, False, sizes, dev)
    parity = len(got) == len(host) > 0 and all(
        (a[ROW_KIND_FIELD], a["k"], a["c"], a["s"]) == (b[ROW_KIND_FIELD], b["k"], b["c"], b["s"])
        and abs(a["a"] - b["a"]) <= 1e-6 * abs(b["a"]) for a, b in zip(got, host))
    device_path = ("GroupAggRunner", True) in kinds
    ok = parity and device_path and steps == -(-len(rows) // sizes["batch"])
    return {"phase": "api_group_agg", "ok": ok, "parity": parity, "device_path": device_path,
            "rows": len(rows), "changelog_rows": len(got), "tuples_per_s": len(rows) / secs,
            "seconds": secs, "host_path_seconds": host_s, "steps": steps}


# ---------------------------------------------------------------------------
# the api_sql phase: bench.py::sql_path_microbench through the port's
# parser, planner and TableEnvironment
# ---------------------------------------------------------------------------

def sql_ysb_job(n: int, fused: bool, sz, dev=DEV):
    """(env, tenv, sink) of the SQL YSB statement over the columnar `ysb`
    table of n records (`bench.py::sql_path_microbench`'s source, which is
    the api stream's columns), `table.device-fusion` = fused."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions, TableOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.table import TableEnvironment, TableSchema
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, sz["keys"]))

    cfg = Configuration()
    cfg.set(TableOptions.DEVICE_FUSION, fused)
    cfg.set(ExecutionOptions.BATCH_SIZE, sz["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, sz["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    tenv = TableEnvironment(env)
    stream = env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
    tenv.register_table("ysb", stream,
                        TableSchema(["campaign", "event_type", "rowtime"], rowtime="rowtime",
                                    field_types=["int", "float", "int"]), columnar=True)
    sink = tenv.sql_query(SQL_YSB).collect()
    return env, tenv, sink


def sql_ds_job(n: int, sz, dev=DEV):
    """(env, sink) of the same program written against the DataStream API,
    with the statement's output rows (`sql_path_microbench`'s build_ds)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, sz["keys"]))

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sz["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, sz["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    sink = (env.from_source(DataGeneratorSource(gen, n),
                            WatermarkStrategy.for_bounded_out_of_orderness(0))
            .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
            .window(SlidingEventTimeWindows.of(sz["window"], sz["slide"]))
            .aggregate("count")
            .map_with_timestamp(lambda rec, ts: {"campaign": rec[0], "views": rec[1],
                                                 "wend": ts + 1}, name="sql_shape_output")
            .collect())
    return env, sink


def sql_counted(env, dev=DEV):
    """One execute() with K1's launch count at 0 just before it: (seconds,
    K1 dispatches)."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    _sync(dev)
    cs.reset_launch_counts()
    secs = timed_execute(env, dev)
    return secs, cs.LAUNCHES["k1_superscan"]


def sql_fired(rows, sz) -> dict:
    """SQL output rows {campaign, views, wend} as {window index: row over
    the keys}."""
    fired = {}
    for r in rows:
        j = (int(r["wend"]) - sz["window"]) // sz["slide"]
        row = fired.get(j)
        if row is None:
            row = fired[j] = np.zeros(sz["keys"])
        row[int(r["campaign"])] = r["views"]
    return fired


def sql_rows_table(sz, dev=DEV):
    """(env, tenv, rows, sink) of the TUMBLE SUM ... HAVING statement over a
    typed row-mode table of sz["rows"] dict rows {k, v, rowtime}: the
    host columnarizer, then the traced key/value extraction and K1's add
    field."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.table import TableEnvironment, TableSchema

    n, rng = sz["rows"], np.random.default_rng(17)
    keys = rng.integers(0, sz["keys"], n).tolist()
    vals = rng.integers(0, 8, n).astype(np.float64).tolist()
    times = (10_000 + np.arange(n, dtype=np.int64) * 64_000 // n).tolist()
    rows = [{"k": k, "v": v, "rowtime": t} for k, v, t in zip(keys, vals, times)]
    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, sz["rows_batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, sz["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    tenv = TableEnvironment(env)
    tenv.from_rows("events", rows, TableSchema(["k", "v", "rowtime"], rowtime="rowtime",
                                               field_types=["int", "float", "int"]))
    sink = tenv.sql_query(
        f"SELECT k, SUM(v) AS s, WINDOW_END AS we FROM events GROUP BY k, "
        f"TUMBLE(rowtime, INTERVAL '{sz['tumble']}' MILLISECOND) "
        f"HAVING s > {sz['having']}").collect()
    return env, tenv, (np.asarray(keys), np.asarray(vals), np.asarray(times)), sink


def sql_rows_oracle(keys, vals, times, sz) -> list:
    """numpy: (k, s, we) of every (key, 2 s window) whose sum passes HAVING."""
    w = times // sz["tumble"]
    flat = w * sz["keys"] + keys
    uniq, inv = np.unique(flat, return_inverse=True)
    sums = np.bincount(inv, weights=vals)
    keep = sums > sz["having"]
    return sorted(zip((uniq[keep] % sz["keys"]).tolist(), sums[keep].tolist(),
                      ((uniq[keep] // sz["keys"] + 1) * sz["tumble"]).tolist()))


def sql_session_statement(sz, dev=DEV):
    """bench.py::sql_path_microbench's fallback statement (SESSION, reason
    `session-window`) on its 512-row typed table: (rows, report, K3 and K4
    launches), the launch counts at 0 just before the run."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.table import TableEnvironment, TableSchema

    tenv = TableEnvironment(StreamExecutionEnvironment(device=dev))
    tenv.from_rows("pay", [{"user": i % 5, "amount": float(i % 3), "rowtime": i * 100}
                           for i in range(sz["session_rows"])],
                   TableSchema(["user", "amount", "rowtime"], rowtime="rowtime",
                               field_types=["int", "float", "int"]))
    _sync(dev)
    cuda_session.reset_launch_counts()
    rows = tenv.execute_sql_to_list("SELECT user, COUNT(*) AS n FROM pay "
                                    "GROUP BY user, SESSION(rowtime, INTERVAL '1' SECOND)")
    _sync(dev)
    return (rows, tenv.last_plan_report, cuda_session.k3_launches(),
            cuda_session.LAUNCHES["k4_session_merge"])


def sql_group_agg(rows, device: bool, sz, dev=DEV):
    """The continuous COUNT(*), SUM, AVG ... GROUP BY over a registered
    changelog table: (changelog, seconds, report)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.table import TableEnvironment, TableSchema

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, API_GROUP_AGG["batch"])
    cfg.set(ExecutionOptions.DEVICE_GROUP_AGG, device)
    env = StreamExecutionEnvironment(cfg, device=dev)
    tenv = TableEnvironment(env)
    tenv.from_rows("t", rows, TableSchema(["k", "v"]))
    sink = tenv.sql_query("SELECT k, COUNT(*) AS c, SUM(v) AS s, AVG(v) AS a FROM t "
                          "GROUP BY k").collect()
    return sink.results, timed_execute(env, dev), tenv.last_plan_report


def api_sql_phase(dev=DEV, sizes=None) -> dict:
    """The SQL front door: the YSB statement fused (DeviceChainRunner and
    the planner's fused report), three-way parity at sizes["parity_events"]
    (SQL fused, SQL interpreted, the DataStream program) against the numpy
    oracle, the fused route timed at sizes["events"] and the interpreted
    one at sizes["interp_events"] with their K1 dispatches; a TUMBLE SUM
    ... HAVING over a typed row-mode table held against numpy; the SESSION
    fallback statement on K3/K4 against numpy_sessionize; the continuous
    GROUP BY on the device accumulators against the host path's."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime import group_agg_operator as ga
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.table.changelog import ROW_KIND_FIELD
    from flink_tpu_torch.testing import stream as st

    sz = dict(API_SQL, **(sizes or {}))
    out = {"phase": "api_sql", "statement": SQL_YSB}
    env, tenv, _sink = sql_ysb_job(sz["warmup_events"], True, sz, dev)
    runners = build_runners(plan(env._sinks), env.config, dev)[0]
    report = tenv.last_plan_report
    out["fused_selected"] = bool(
        any(type(r).__name__ == "DeviceChainRunner" for r in runners)
        and report is not None and report.fused)
    out["plan"] = report.describe()
    sql_counted(env, dev)                                   # warm

    # three-way parity against the numpy oracle
    n = sz["parity_events"]
    ref = st.api_replay(n, sz["batch"], window_ms=sz["window"],
                        slide_ms=sz["slide"], num_keys=sz["keys"])
    routes = {}
    for route in ("fused", "interpreted", "datastream"):
        if route == "datastream":
            env, sink = sql_ds_job(n, sz, dev)
            rep = None
        else:
            env, tenv, sink = sql_ysb_job(n, route == "fused", sz, dev)
            rep = tenv.last_plan_report
        secs, k1 = sql_counted(env, dev)
        fired = sql_fired(sink.results, sz)
        ok, checked = st.parity(ref.fired, fired, require_all=True)
        routes[route] = {"parity": ok and set(fired) <= set(ref.fired),
                         "windows_checked": checked, "rows": len(sink.results),
                         "k1_dispatches": k1, "seconds": secs,
                         "path": rep.path if rep else None,
                         "reason": rep.reason if rep else None,
                         "key": sorted((int(r["campaign"]), int(r["wend"]), int(r["views"]))
                                       for r in sink.results)}
    same = routes["fused"]["key"] == routes["interpreted"]["key"] == routes["datastream"]["key"]
    for r in routes.values():
        del r["key"]
    out["parity"] = same and all(r["parity"] for r in routes.values())
    out["parity_routes"] = routes

    # timed: the fused route at sizes["events"], the interpreted one at
    # sizes["interp_events"], best of sizes["runs"]
    timed = {}
    for route, fused, n in (("fused", True, sz["events"]),
                            ("interpreted", False, sz["interp_events"])):
        runs = []
        for _ in range(sz["runs"]):
            env, _tenv, sink = sql_ysb_job(n, fused, sz, dev)
            secs, k1 = sql_counted(env, dev)
            runs.append((secs, k1, len(sink.results)))
        best = min(r[0] for r in runs)
        timed[route] = {"events": n, "tuples_per_s": n / best, "seconds": best,
                        "all_seconds": [r[0] for r in runs], "k1_dispatches": runs[0][1],
                        "rows": runs[0][2]}
    out["timed"] = timed
    out["fused_tuples_per_s"] = timed["fused"]["tuples_per_s"]
    out["interpreted_tuples_per_s"] = timed["interpreted"]["tuples_per_s"]
    dispatched = timed["fused"]["k1_dispatches"] > 0 and routes["fused"]["k1_dispatches"] > 0

    # TUMBLE SUM ... HAVING over a typed row-mode table of dict rows
    t0 = time.perf_counter()
    env, tenv, cols, sink = sql_rows_table(sz, dev)
    build_s = time.perf_counter() - t0
    secs, k1 = sql_counted(env, dev)
    got = sorted((int(r["k"]), float(r["s"]), int(r["we"])) for r in sink.results)
    want = sql_rows_oracle(*cols, sz)
    rep = tenv.last_plan_report
    out["row_mode_sum"] = {"rows": sz["rows"], "emitted": len(got),
                           "parity": got == want and len(got) > 0, "fused": rep.fused,
                           "k1_dispatches": k1, "seconds": secs, "tuples_per_s":
                           sz["rows"] / secs, "build_rows_s": build_s,
                           "plan": rep.describe()}

    # the SESSION fallback statement, executed on K3/K4
    rows, rep, k3, k4 = sql_session_statement(sz, dev)
    n_s = sz["session_rows"]
    sess = st.numpy_sessionize(np.arange(n_s) % 5, np.arange(n_s) * 100, np.ones(n_s), 1000)
    want = sorted((k, int(v)) for (k, _s, _e), v in sess.items())
    parity_s = sorted((r["user"], r["n"]) for r in rows) == want
    on_card = torch.device(dev).type == "cuda"
    out["session"] = {"parity": parity_s, "path": rep.path, "reason": rep.reason,
                      "k3_launches": k3, "k4_launches": k4, "sessions": len(rows),
                      "failed": [name for name, good in (
                          ("parity_numpy_sessionize", parity_s),
                          ("k3_launched", k3 > 0 or not on_card),
                          ("k4_launched", k4 > 0 or not on_card)) if not good]}

    # the continuous GROUP BY, device accumulators against the host path
    crow = st.changelog_rows(sz["group_rows"], sz["group_keys"],
                             API_GROUP_AGG["retract"])
    ga.CALLS["group_agg_step"] = 0
    got, secs, rep = sql_group_agg(crow, True, sz, dev)
    steps = ga.CALLS["group_agg_step"]
    host, host_s, _r = sql_group_agg(crow, False, sz, dev)
    out["continuous"] = {
        "rows": len(crow), "changelog_rows": len(got), "steps": steps,
        "parity": len(got) == len(host) > 0 and all(
            (a[ROW_KIND_FIELD], a["k"], a["c"], a["s"])
            == (b[ROW_KIND_FIELD], b["k"], b["c"], b["s"])
            and abs(a["a"] - b["a"]) <= 1e-6 * abs(b["a"]) for a, b in zip(got, host)),
        "path": rep.path, "reason": rep.reason, "seconds": secs,
        "host_path_seconds": host_s, "tuples_per_s": len(crow) / secs}

    out["ok"] = bool(
        out["fused_selected"] and out["parity"] and dispatched
        and routes["interpreted"]["reason"] == "disabled"
        and out["row_mode_sum"]["parity"] and out["row_mode_sum"]["fused"]
        and out["row_mode_sum"]["k1_dispatches"] > 0
        and out["session"]["parity"] and out["session"]["reason"] == "session-window"
        and (torch.device(dev).type != "cuda" or (k3 > 0 and k4 > 0))
        and out["continuous"]["parity"] and steps > 0)
    return out


def sql_k1_inputs(dev=DEV):
    """K1's inputs of the SQL job's first full fused dispatch (32 steps of
    8192 records of the 2^21-record table), through the statement's own
    lowered filter and key: (pipe, agg, idx, vals, plan)."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue

    _env, tenv, _sink = sql_ysb_job(API_SQL["batch"], True, API_SQL, dev)
    term = tenv.last_plan_report.lowered.terminal
    mask = term.inputs[0].inputs[0].config["fn"]
    prologue = TracedPrologue((("filter", mask),), term.config["key_selector"])
    agg = resolve("count")
    pipe, idx, vals, plan = k1_dispatch_inputs(
        SlidingEventTimeWindows.of(API_SQL["window"], API_SQL["slide"]), agg, prologue,
        API_SQL["events"], API_SQL["batch"], False, dev)
    return pipe, agg, idx, vals, plan


# ---------------------------------------------------------------------------
# phase 18: latency mode (execution.latency.*) on the api_ysb program
# ---------------------------------------------------------------------------

def timing_sink():
    """A sink that keeps each batch it is given (`.batches`: (values,
    timestamps)) and when it came (`.arrivals`: (host seconds, rows so
    far))."""
    from flink_tpu_torch.connectors.sink import Sink, SinkWriter

    class Writer(SinkWriter):
        def __init__(self, sink):
            self.sink = sink

        def write_batch(self, values, timestamps=None):
            self.sink.batches.append((values, timestamps))
            self.sink.rows += len(values)
            self.sink.arrivals.append((time.perf_counter(), self.sink.rows))

    class TimingSink(Sink):
        def __init__(self):
            self.batches, self.arrivals, self.rows = [], [], 0

        def create_writer(self):
            return Writer(self)

    return TimingSink()


def latency_runtime(n: int, latency: bool, sz, dev=DEV):
    """(runtime, fused operator, sink) of the api_ysb fused program
    (traceable filter and key, 10 s / 1 s count, 8192 keys, batch 65536, 32
    steps a superbatch, columnar output) over n records, with the
    execution.latency.* options of sz when `latency`. Built through the
    executor's JobRuntime (what env.execute() runs), so the caller reaches
    the operator."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import JobRuntime
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, API["keys"]))

    conf = {"execution.step.batch-size": API["batch"],
            "execution.state.key-capacity": API["keys"],
            "execution.window.columnar-output": True,
            "execution.window.superbatch-steps": 32}
    if latency:
        conf.update({"execution.latency.target-ms": sz["target_ms"],
                     "execution.latency.readback-steps": sz["readback_steps"],
                     "execution.latency.max-inflight-dispatches": sz["max_inflight"]})
    env = StreamExecutionEnvironment(Configuration(conf), device=dev)
    sink = timing_sink()
    (env.from_source(DataGeneratorSource(gen, n),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
     .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
     .window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
     .aggregate("count").sink_to(sink))
    runtime = JobRuntime(plan(env._sinks), env.config, dev)
    op = next(r.op for r in runtime.runners if type(r).__name__ == "DeviceChainRunner")
    return runtime, op, sink


def latency_run(n: int, latency: bool, sz, rung=None, dev=DEV) -> dict:
    """One run of the program; `rung`: the ladder rung to pin the
    controller at (a constant clock leaves its rate estimate unset, so it
    holds the rung). Each dispatch's enqueue time, K1 launches and depth
    are recorded, and the rows each resolve appends; matched with the
    sink's arrivals they give the time from the run's start to the first
    row at the sink and the mean lag from a dispatch's enqueue to its last
    row at the sink. K1's launch counts are 0 just before the run."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    runtime, op, sink = latency_runtime(n, latency, sz, dev)
    if rung is not None:
        op._controller._clock = lambda: 0.0
        op._controller._rung = rung
    dispatches, resolved = [], []       # (t, K1 launches, depth); (t_enqueue, rows so far)
    appended = [0]
    run_raw, resolve = op.pipe.process_superbatch_raw, op._resolve_oldest

    def timed_dispatch(steps, wms, **kw):
        before = cs.LAUNCHES["k1_superscan"]
        t = time.perf_counter()
        d = run_raw(steps, wms, **kw)
        dispatches.append((t, cs.LAUNCHES["k1_superscan"] - before, len(steps)))
        return d

    def timed_resolve():
        t_enq = dispatches[len(resolved)][0]
        before = len(op.output)
        resolve()
        appended[0] += len(op.output) - before
        resolved.append((t_enq, appended[0]))

    op.pipe.process_superbatch_raw, op._resolve_oldest = timed_dispatch, timed_resolve
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    runtime.run()
    _sync(dev)
    secs = time.perf_counter() - t0
    lags, prev, a = [], 0, 0
    arrivals = sink.arrivals
    for t_enq, upto in resolved:
        if upto == prev:
            continue                     # a dispatch that fired nothing
        while arrivals[a][1] < upto:
            a += 1
        lags.append(arrivals[a][0] - t_enq)
        prev = upto
    rows = [(r[0].start, np.asarray(r[1]).tolist(), np.asarray(r[2]).tolist())
            for values, _ts in sink.batches for r in values]
    return {"seconds": secs, "tuples_per_s": n / secs,
            "first_row_s": arrivals[0][0] - t0 if arrivals else None,
            "mean_enqueue_to_sink_ms": float(np.mean(lags)) * 1e3 if lags else None,
            "dispatches": len(dispatches), "k1_launches": cs.LAUNCHES["k1_superscan"],
            "k1_launches_by_depth": sorted({(d, k) for _t, k, d in dispatches}),
            "depths": sorted({d for _t, _k, d in dispatches}),
            "gauges": op.latency_gauges(), "rows": rows}


def api_latency_phase(dev=DEV, sizes=None) -> dict:
    """Latency mode on the api_ysb fused program at sizes["events"]
    records: a throughput-mode run, a latency-mode run
    (execution.latency.target-ms, readback-steps, max-inflight-dispatches
    from sizes), and a latency-mode run with the rung pinned at each rung
    of the ladder. Every run's packed rows must equal the throughput run's,
    in order, and the numpy oracle's."""
    from flink_tpu_torch.scheduler.latency_controller import build_rung_ladder
    from flink_tpu_torch.testing import stream as st

    sz = sizes or API_LATENCY
    n = sz["events"]
    latency_run(sz["warmup_events"], True, sz, dev=dev)            # build, warm
    base = latency_run(n, False, sz, dev=dev)
    lat = latency_run(n, True, sz, dev=dev)
    ladder = build_rung_ladder(2, 32)
    pinned = {r: latency_run(n, True, sz, rung=i, dev=dev) for i, r in enumerate(ladder)}
    ref = st.api_replay(n, API["batch"], window_ms=API["window"], slide_ms=API["slide"],
                        num_keys=API["keys"])
    fired = {}
    for start, ids, vals in base["rows"]:
        row = fired[start // API["slide"]] = np.zeros(API["keys"])
        row[ids] = vals
    parity, checked = st.parity(ref.fired, fired, require_all=True)
    parity = parity and set(fired) <= set(ref.fired)
    same = {"latency": lat["rows"] == base["rows"]}
    same.update({f"rung_{r}": run["rows"] == base["rows"] for r, run in pinned.items()})
    full = pinned[32]
    full_launches = [k for d, k in full["k1_launches_by_depth"] if d == 32]
    grouped_ok = full_launches == [32 // sz["readback_steps"]]
    launched = all(run["k1_launches"] > 0 for run in (base, lat, *pinned.values()))

    def summary(run):
        return {k: run[k] for k in ("seconds", "tuples_per_s", "first_row_s",
                                    "mean_enqueue_to_sink_ms", "dispatches", "k1_launches",
                                    "k1_launches_by_depth", "depths", "gauges")}

    return {"phase": "api_latency",
            "ok": parity and all(same.values()) and grouped_ok and launched,
            "events": n, "options": {k: sz[k] for k in ("target_ms", "readback_steps",
                                                         "max_inflight")},
            "parity": parity, "windows_checked": checked, "rows_equal_throughput": same,
            "k1_launches_a_full_dispatch": full_launches,
            "throughput_tuples_per_s": base["tuples_per_s"],
            "latency_tuples_per_s": lat["tuples_per_s"],
            "throughput": summary(base), "latency": summary(lat),
            "pinned": {r: summary(run) for r, run in pinned.items()}}


def k1_group_inputs(Tg: int, dev=DEV):
    """K1's inputs of the first readback group of Tg steps of the api_ysb
    count job's first full dispatch (B = 65536), as `_process_grouped`
    launches it: (pipe, agg, idx, vals, plan with the group's fires, R)."""
    pipe, agg, idx, vals, plan = api_k1_inputs(False, dev)
    B = idx.numel() // int(plan[0].shape[0])
    fires = [pf for pf in plan[5] if pf.step < Tg]
    R = min(pipe.R, -(-max(len(fires), 1) // 16) * 16)
    g_plan = tuple(p[:Tg] for p in plan[:5]) + (fires,)
    return pipe, agg, idx[:Tg * B], None, g_plan, R


# ---------------------------------------------------------------------------
# C3: K1 with an int add field
# ---------------------------------------------------------------------------

C3_INPUTS = ([16777216.0, 1.0], [0.5, 0.5])
#: what the JAX package's FusedWindowOperator emits on them (a float32 sum
#: of the cell, cast once): tests/test_torch_64bit_fields.py holds it
C3_JAX_ROWS = [16777216, 1]


def k1_int_sum_phase(card: str, dev=DEV) -> dict:
    """ROADMAP C3 on the card. The fused operator with sum_agg(np.int64)
    on C3's inputs (one key, one tumbling window; launch counts at 0 just
    before) must emit the JAX package's rows, as its CPU route does; then
    K1 with an int32 add field against its plain version at the api_ysb sum
    job's first full dispatch, the payload turned to quarter values (a cast
    per record would lose their fractions; their float32 partial sums are
    exact in any order), with its times."""
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops.aggregators import sum_agg
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator

    def c3_rows(device):
        rows = []
        for vals in C3_INPUTS:
            op = FusedWindowOperator(TumblingEventTimeWindows.of(1000), sum_agg(np.int64),
                                     device=device)
            op.process_batch(np.array([1, 1]), np.array(vals, np.float32), np.array([10, 20]))
            op.process_watermark(5000)
            op.flush_all()
            rows += [r for _k, _w, r, _t in op.drain_output()]
        return rows

    cs.reset_launch_counts()
    card_rows = c3_rows(dev)
    launches = cs.LAUNCHES["k1_superscan"]
    cpu_rows = c3_rows("cpu")
    pipe, _agg, idx, vals, plan = api_k1_inputs(True, dev)
    quarters = vals + torch.remainder(torch.arange(vals.numel(), device=vals.device), 4) / 4
    entry = k1_at_dispatch("api_ysb int32 sum of quarter values: the sum job's first full "
                           "fused dispatch", pipe, sum_agg(np.int32), idx,
                           quarters.to(torch.float32).contiguous(), plan)
    ok = card_rows == cpu_rows == C3_JAX_ROWS and launches == len(C3_INPUTS)
    return {"phase": "k1_int_sum", "card": card, "ok": ok, "c3_rows": card_rows,
            "c3_cpu_rows": cpu_rows, "c3_jax_rows": C3_JAX_ROWS, "launches": launches,
            **entry}


# ---------------------------------------------------------------------------
# phase 19: the per-record oracle operator (host code: the device takes no
# part in these jobs)
# ---------------------------------------------------------------------------

#: the JAX package's plan report of SQL_MULTI (tests/test_torch_chip_smoke.py
#: holds it against flink_tpu's TableEnvironment)
SQL_MULTI_REPORT = ("interpreted", "multi-aggregate",
                    "interpreted[multi-aggregate]: 3 aggregate calls")


def oracle_columns(n: int, keys: int, span_ms: int):
    """n records (key, value) float32 with ordered int64 timestamps over
    span_ms: keys by a multiplicative hash, values small integers."""
    idx = np.arange(n, dtype=np.int64)
    col = np.stack([(idx * 2654435761) % keys, (idx * 7) % 11], axis=1).astype(np.float32)
    return col, 10_000 + idx * span_ms // n


def oracle_job(job: str, sz, dev=DEV):
    """(env, sink) of a per-record oracle job over the columns above:
    'continuous_reduce' (10 s / 1 s windows, ContinuousEventTimeTrigger.of
    (500), reduce summing the value) or 'evictor_process' (2 s tumbling
    windows, CountEvictor.of(16), a ProcessWindowFunction giving
    (key, start, elements, their value sum))."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import ProcessWindowFunction
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.api.windowing.evictors import CountEvictor
    from flink_tpu_torch.api.windowing.triggers import ContinuousEventTimeTrigger
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    p = sz[job]
    col, ts = oracle_columns(p["events"], sz["keys"], p["span_ms"])

    def gen(idx):
        return Batch(col[idx], ts[idx])

    class LastElements(ProcessWindowFunction):
        def process(self, key, context, elements):
            elements = list(elements)
            yield (key, context.window.start, len(elements),
                   float(sum(float(e[1]) for e in elements)))

    env = StreamExecutionEnvironment(
        Configuration({"execution.step.batch-size": p["batch"]}), device=dev)
    keyed = (env.from_source(DataGeneratorSource(gen, p["events"]),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .key_by(lambda r: int(r[0])))
    if job == "continuous_reduce":
        out = (keyed.window(SlidingEventTimeWindows.of(p["window"], p["slide"]))
               .trigger(ContinuousEventTimeTrigger.of(p["interval"]))
               .reduce(lambda a, b: (a[0], float(a[1]) + float(b[1]))))
    else:
        out = (keyed.window(TumblingEventTimeWindows.of(p["window"]))
               .evictor(CountEvictor.of(p["keep"])).process(LastElements()))
    sink = rows_sink()
    out.sink_to(sink)
    return env, sink


def _window_groups(keys, ts, size, slide):
    """For each (record, window) pair of sliding windows: (record index,
    key, window start), record-major."""
    last = ts - ts % slide
    per = size // slide
    rec = np.repeat(np.arange(len(ts)), per)
    start = np.repeat(last, per) - np.tile(np.arange(per), len(ts)) * slide
    return rec, np.repeat(keys, per), start


def continuous_reduce_model(sz) -> list:
    """numpy model of 'continuous_reduce': every (key, window) with records
    fires at each multiple of the interval from its first record's on (the
    first at floor(t0 / interval) * interval + interval), and at its end;
    a fire at time f sees the window's records of every batch up to the
    first whose watermark (its largest timestamp - 1) reaches f. The end of
    input's watermark jumps past every window at once, and the timer
    service fires the timers due at one advance as a batch: an open window
    then fires at its pending interval timer and at its end, and its end's
    cleanup drops the timer the first fire registered (one advance of a
    batch never passes two of a window's fire times: it moves less than
    the interval). Sorted (key, window start, value sum) of every fire."""
    p = sz["continuous_reduce"]
    col, ts = oracle_columns(p["events"], sz["keys"], p["span_ms"])
    keys, vals = col[:, 0].astype(np.int64), col[:, 1].astype(np.float64)
    B = p["batch"]
    wms = np.maximum.accumulate(ts)[np.minimum(np.arange(B, len(ts) + B, B), len(ts)) - 1] - 1
    rec, k, start = _window_groups(keys, ts, p["window"], p["slide"])
    order = np.lexsort((rec, start, k))
    rec, k, start = rec[order], k[order], start[order]
    bounds = np.flatnonzero(np.r_[True, (k[1:] != k[:-1]) | (start[1:] != start[:-1]), True])
    out, iv = [], p["interval"]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        r = rec[lo:hi]
        end_max = start[lo] + p["window"] - 1
        t0 = int(ts[r[0]])
        fires, f = [], min(t0 - t0 % iv + iv, end_max)
        while f < end_max and f <= wms[-1]:
            fires.append(f)
            f = min(f + iv, end_max)
        if f < end_max:
            fires.append(f)                           # pending at the final jump
        fires.append(end_max)
        csum = np.cumsum(vals[r])
        for f in fires:
            b = int(np.searchsorted(wms, f))          # the first batch reaching f
            cut = len(ts) if b >= len(wms) else (b + 1) * B
            m = int(np.searchsorted(r, cut))
            out.append((int(k[lo]), int(start[lo]), float(csum[m - 1])))
    return sorted(out)


def evictor_process_model(sz) -> list:
    """numpy model of 'evictor_process': each (key, window) fires once at
    its end with its last `keep` records. Sorted (key, start, n, sum)."""
    p = sz["evictor_process"]
    col, ts = oracle_columns(p["events"], sz["keys"], p["span_ms"])
    keys, vals = col[:, 0].astype(np.int64), col[:, 1].astype(np.float64)
    start = ts - ts % p["window"]
    order = np.lexsort((np.arange(len(ts)), start, keys))
    k, s, v = keys[order], start[order], vals[order]
    bounds = np.flatnonzero(np.r_[True, (k[1:] != k[:-1]) | (s[1:] != s[:-1]), True])
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        kept = v[max(lo, hi - p["keep"]):hi]
        out.append((int(k[lo]), int(s[lo]), len(kept), float(kept.sum())))
    return sorted(out)


def sql_multi_job(n: int, sz, dev=DEV):
    """(env, tenv, sink) of SQL_MULTI over the `ysb` table of n records
    with the payload column x (api_columns' payload)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.table import TableEnvironment, TableSchema
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, API["keys"], payload=True))

    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": sz["sql_batch"],
        "execution.state.key-capacity": API["keys"]}), device=dev)
    tenv = TableEnvironment(env)
    stream = env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
    tenv.register_table("ysb", stream,
                        TableSchema(["campaign", "event_type", "x", "rowtime"],
                                    rowtime="rowtime",
                                    field_types=["int", "float", "float", "int"]),
                        columnar=True)
    sink = tenv.sql_query(SQL_MULTI).collect()
    return env, tenv, sink


def sql_multi_model(n: int) -> dict:
    """numpy: {aggregate: {window index: row over the keys}} of SQL_MULTI's
    COUNT(*), SUM(x) and MAX(x)."""
    from flink_tpu_torch.testing import stream as st

    reps = {agg: st.api_replay(n, API["batch"], window_ms=API["window"],
                               slide_ms=API["slide"], agg=agg, num_keys=API["keys"]).fired
            for agg in ("count", "sum", "max")}
    return reps


def _reset_launch_counts() -> None:
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import cuda_superscan as cs

    cs.reset_launch_counts()
    cuda_session.reset_launch_counts()


def _oracle_untouched_device(dev) -> bool:
    """No kernel of the port launched since the counts were last reset."""
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import cuda_superscan as cs

    _sync(dev)
    return not any(cs.LAUNCHES.values()) and not any(cuda_session.LAUNCHES.values())


def api_oracle_phase(dev=DEV, sizes=None) -> dict:
    """The per-record oracle operator's jobs, each against a numpy model of
    its semantics, with tuples/s (host clock, one env.execute()), a
    cProfile of a second run at a quarter of the records, and a check that
    no kernel of the port launched: the oracle is host code, the device
    takes no part."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    sz = sizes or API_ORACLE
    out = {"phase": "api_oracle",
           "device": "none: the per-record oracle operator is host code, as in the JAX package"}
    ok = True
    models = {"continuous_reduce": continuous_reduce_model,
              "evictor_process": evictor_process_model}
    for job, model in models.items():
        env, sink = oracle_job(job, sz, dev)
        selected = [type(r.op).__name__ for r in build_runners(plan(env._sinks), env.config,
                                                                dev)[0]
                    if hasattr(r, "op")] == ["OracleWindowOperator"]
        _reset_launch_counts()
        secs = timed_execute(env, dev)
        untouched = _oracle_untouched_device(dev)
        got = []
        for values, tss in sink.batches:
            for row, t in zip(values, tss):
                start = int(t) + 1 - sz[job]["window"]
                if job == "continuous_reduce":
                    # (key, reduce result): the first record's row alone, else
                    # the (key, value sum) tuple the reduce builds
                    got.append((int(row[0]), start, float(row[1][1])))
                else:
                    got.append(tuple(row))
        parity = sorted(got) == model(sz) and len(got) > 0
        quarter = dict(sz, **{job: dict(sz[job], events=sz[job]["events"] // 4)})
        prof = host_profile(f"api_oracle_{job}", lambda q=quarter, j=job: timed_execute(
            oracle_job(j, q, dev)[0], dev), top=8)
        n = sz[job]["events"]
        out[job] = {"events": n, "tuples_per_s": n / secs, "seconds": secs,
                    "rows": len(got), "parity": parity, "oracle_selected": selected,
                    "no_kernel_launched": untouched, "host_profile": prof["top"]}
        ok = ok and parity and selected and untouched
    # SQL_MULTI: three aggregates on the composite accumulator
    n = sz["sql_events"]
    env, tenv, sink = sql_multi_job(n, sz, dev)
    _reset_launch_counts()
    secs = timed_execute(env, dev)
    untouched = _oracle_untouched_device(dev)
    r = tenv.last_plan_report
    report = (r.path, r.reason, r.describe())
    model = sql_multi_model(n)
    got = sorted((int(row["wend"]), int(row["campaign"]), int(row["views"]), float(row["s"]),
                  float(row["m"])) for row in sink.results)
    want = []
    for j, counts in model["count"].items():
        for key in np.flatnonzero(counts > 0):
            want.append((j * API["slide"] + API["window"], int(key), int(counts[key]),
                         float(model["sum"][j][key]), float(model["max"][j][key])))
    parity = got == sorted(want) and len(got) > 0
    out["sql_multi"] = {"events": n, "tuples_per_s": n / secs, "seconds": secs,
                        "rows": len(sink.results), "parity": parity, "report": report,
                        "report_equals_jax": report == SQL_MULTI_REPORT,
                        "no_kernel_launched": untouched}
    out["ok"] = ok and parity and report == SQL_MULTI_REPORT and untouched
    return out


# ---------------------------------------------------------------------------
# phase 20: shared correlated windows (graph/window_sharing.py) — sibling
# window() steps over one keyed stream as one shared-partial K1 program
# ---------------------------------------------------------------------------

API_CORRELATED = dict(keys=8192, batch=65536, parity_events=1 << 19, timed_events=1 << 22,
                      warmup_events=1 << 17, runs=3, wide_keys=1 << 20, wide_events=1 << 22,
                      latency_events=1 << 21, target_ms=50, readback_steps=8)
#: 2 h of event time: two 1 h windows
CORRELATED_SPAN_MS = 2 * 3_600_000
#: leg 1, bench.py::correlated_windows_microbench's members: 1 min, 5 min,
#: 1 h tumbling counts
DASHBOARD = (("tumbling", 60_000), ("tumbling", 300_000), ("tumbling", 3_600_000))
#: leg 2: five members on a 1 min granule (1, 5, 15, 60 min tumbling, 10
#: min sliding by 1): 20 fire slots with mixed window lengths
DASHBOARD_WIDE = (("tumbling", 60_000), ("tumbling", 300_000), ("tumbling", 900_000),
                  ("tumbling", 3_600_000), ("sliding", 600_000, 60_000))
#: K1's unstaged-ring check: a 24 h window sliding by 1 min (1440 slices,
#: S = 2048) beside a 1 min one
UNSTAGED = (("tumbling", 60_000), ("sliding", 86_400_000, 60_000))


def _member(m):
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )

    if m[0] == "tumbling":
        return TumblingEventTimeWindows.of(m[1])
    return SlidingEventTimeWindows.of(m[1], m[2])


def correlated_columns(idx: np.ndarray, n: int, keys: int):
    """correlated_windows_microbench's stream: (campaign, event_type)
    columns over 2 h of event time."""
    camp = (idx * 2654435761) % keys
    col = np.stack([camp, idx % 3], axis=1).astype(np.float32)
    return col, (10_000 + idx * CORRELATED_SPAN_MS // n).astype(np.int64)


def correlated_env(n: int, shared: bool, *, columnar: bool, members=DASHBOARD, keys=None,
                   latency: bool = False, mesh: int = 0, hook=None, make_sink=rows_sink,
                   sz=API_CORRELATED, dev=DEV):
    """(env, sinks) of the program: a traceable filter keeping event_type
    0, a traceable key, a `count` window per member, batch 65536, with
    execution.window.shared-partials `shared`; `mesh` > 0 runs it with
    parallel.mesh.enabled over that many shards. hook(idx) runs before
    each source batch; make_sink() makes each member's sink."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    keys = keys or sz["keys"]
    conf = {"execution.step.batch-size": sz["batch"], "execution.state.key-capacity": keys,
            "execution.window.columnar-output": columnar,
            "execution.window.shared-partials": shared}
    if latency:
        conf.update({"execution.latency.target-ms": sz["target_ms"],
                     "execution.latency.readback-steps": sz["readback_steps"]})
    if mesh:
        conf.update({"parallel.mesh.enabled": True, "parallel.mesh.devices": mesh})
    env = StreamExecutionEnvironment(Configuration(conf), device=dev)

    def gen(idx):
        if hook is not None:
            hook(idx)
        return Batch(*correlated_columns(idx, n, keys))

    keyed = (env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
             .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True))
    sinks = []
    for m in members:
        sinks.append(make_sink())
        keyed.window(_member(m)).aggregate("count").sink_to(sinks[-1])
    return env, sinks


def correlated_run(n: int, shared: bool, *, columnar: bool, members=DASHBOARD, keys=None,
                   latency: bool = False, mesh: int = 0, sz=API_CORRELATED, dev=DEV) -> dict:
    """One run of correlated_env's program through the executor's
    JobRuntime, what env.execute() runs; K1's launch counts at 0 just
    before it. Returns the sinks, seconds, K1 launches (lanes entry and
    partials entry), runner kinds and the fused runners' mesh sizes."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.executor import JobRuntime

    env, sinks = correlated_env(n, shared, columnar=columnar, members=members, keys=keys,
                                latency=latency, mesh=mesh, sz=sz, dev=dev)
    runtime = JobRuntime(plan(env._sinks), env.config, dev)
    kinds = sorted(type(r).__name__ for r in runtime.runners)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    runtime.run()
    _sync(dev)
    secs = time.perf_counter() - t0
    return {"sinks": sinks, "seconds": secs, "tuples_per_s": n / secs,
            "k1_launches": cs.LAUNCHES["k1_superscan"],
            "k1_partials": cs.LAUNCHES["k1_partials"], "kinds": kinds,
            "mesh_devices": sorted({r.op.mesh_devices() for r in runtime.runners
                                    if hasattr(getattr(r, "op", None), "mesh_devices")})}


def _shared_selected(kinds, members: int) -> bool:
    return (kinds.count("SharedWindowRunner") == 1
            and kinds.count("SharedWindowSiblingRunner") == members - 1
            and "DeviceChainRunner" not in kinds)


def correlated_rows(sink) -> dict:
    """Row-mode sink records as {(window max timestamp, key): count}."""
    return {(int(t), int(k)): int(v) for values, ts in sink.batches
            for (k, v), t in zip(values, ts)}


def correlated_fires(sink) -> list:
    """Columnar sink records in order: (start, end, key ids, counts) a fire."""
    return [(int(r[0].start), int(r[0].end), np.asarray(r[1]), np.asarray(r[2]))
            for values, _ts in sink.batches for r in values]


def _fires_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x[:2] == y[:2] and np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
        for x, y in zip(a, b))


def correlated_model(n: int, keys: int, m) -> dict:
    """numpy: {(window max timestamp, key): count} of one member over the
    records the filter keeps."""
    idx = np.arange(n, dtype=np.int64)[::3]            # event_type 0
    camp = (idx * 2654435761) % keys
    ts = 10_000 + idx * CORRELATED_SPAN_MS // n
    size, slide = (m[1], m[1]) if m[0] == "tumbling" else (m[1], m[2])
    out = {}
    for back in range(size // slide):                  # the windows a record is in
        j = ts // slide - back
        cells, counts = np.unique(j * keys + camp, return_counts=True)
        for c, v in zip(cells.tolist(), counts.tolist()):
            key = (int(c // keys) * slide + size - 1, int(c % keys))
            out[key] = out.get(key, 0) + v
    return out


def correlated_k1_inputs(members, keys: int, n: int, batch=API_CORRELATED["batch"], dev=DEV):
    """K1's inputs of a shared program's first full dispatch (32 steps of
    65536 records of the n-record stream), made by the shared pipeline's
    own staging and prologue at the operator's geometry: (pipe, agg, idx,
    vals, plan)."""
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.runtime.fused_window_pipeline import (
        SharedWindowPipeline,
        TracedPrologue,
    )

    B, T = batch, 32
    agg = resolve("count")
    pipe = SharedWindowPipeline([_member(m) for m in members], agg, key_capacity=keys,
                                nsb=4, fires_per_step=4, out_rows=256, chunk=4096,
                                prologue=TracedPrologue((("filter", _t_filter),), _t_key),
                                device=dev)
    steps, wms = [], []
    for t in range(T):
        col, ts = correlated_columns(np.arange(t * B, (t + 1) * B, dtype=np.int64), n, keys)
        steps.append((col, ts))
        wms.append(int(ts.max()) - 1)
    raw, srel, ts, plan = pipe.stage_superbatch_raw(steps, wms)
    idx, vals, _bounds = pipe._run_prologue(raw, srel, ts)
    return pipe, agg, idx, vals, plan


def api_correlated_phase(dev=DEV, sizes=None) -> dict:
    """Shared correlated windows on the port, three legs.

    1. correlated_windows_microbench's program (1 min / 5 min / 1 h
       tumbling counts, 8192 keys): in row mode at parity_events, the shared
       program, the same job with shared partials off and a numpy model,
       window by window; one SharedWindowRunner and two siblings built; then
       shared and independent interleaved in columnar mode at timed_events,
       best of `runs`.
    2. five members on a 1 min granule (F = 20, mixed spws) at 2^20 keys,
       wide_events records, columnar: shared and independent equal array for
       array, each member's counts summing to its windows' records.
    3. leg 1's program in latency mode (target-ms, readback-steps) at
       latency_events, columnar: its rows equal throughput mode's, in order,
       and a full dispatch is 32 / readback-steps K1 launches."""
    sz = sizes or API_CORRELATED
    out = {"phase": "api_correlated"}

    # ---- leg 1 ----
    n = sz["parity_events"]
    correlated_run(sz["warmup_events"], True, columnar=True, sz=sz, dev=dev)      # build, warm
    correlated_run(sz["warmup_events"], False, columnar=True, sz=sz, dev=dev)
    shared = correlated_run(n, True, columnar=False, sz=sz, dev=dev)
    indep = correlated_run(n, False, columnar=False, sz=sz, dev=dev)
    per_member, parity = [], True
    for i, m in enumerate(DASHBOARD):
        got, other = correlated_rows(shared["sinks"][i]), correlated_rows(indep["sinks"][i])
        model = correlated_model(n, sz["keys"], m)
        ok = got == other == model and len(got) > 0
        parity = parity and ok
        per_member.append({"member": m, "parity": ok, "rows": len(got),
                           "windows_checked": len({t for t, _k in model})})
    selected = (_shared_selected(shared["kinds"], len(DASHBOARD))
                and indep["kinds"].count("DeviceChainRunner") == len(DASHBOARD))
    timed = {"shared": [], "independent": []}
    for _ in range(sz["runs"]):
        for name, on in (("shared", True), ("independent", False)):
            r = correlated_run(sz["timed_events"], on, columnar=True, sz=sz, dev=dev)
            timed[name].append({k: r[k] for k in ("seconds", "tuples_per_s", "k1_launches")})
    best = {name: max(runs, key=lambda r: r["tuples_per_s"]) for name, runs in timed.items()}
    out["leg1"] = {
        "events": n, "parity": parity, "members": per_member,
        "parity_k1_launches": {"shared": shared["k1_launches"],
                               "independent": indep["k1_launches"]},
        "shared_kinds": shared["kinds"], "independent_kinds": indep["kinds"],
        "timed_events": sz["timed_events"],
        "shared_tuples_per_s": best["shared"]["tuples_per_s"],
        "independent_tuples_per_s": best["independent"]["tuples_per_s"],
        "shared_over_independent": (best["shared"]["tuples_per_s"]
                                    / best["independent"]["tuples_per_s"]),
        "k1_launches": {name: best[name]["k1_launches"] for name in best},
        "timed": timed}
    out["shared_selected"] = selected
    del shared, indep

    # ---- leg 2: a wide group at 2^20 keys ----
    wide = {}
    for name, on in (("shared", True), ("independent", False)):
        r = correlated_run(sz["wide_events"], on, columnar=True, members=DASHBOARD_WIDE,
                           keys=sz["wide_keys"], sz=sz, dev=dev)
        wide[name] = {"fires": [correlated_fires(s) for s in r["sinks"]],
                      **{k: r[k] for k in ("seconds", "tuples_per_s", "k1_launches", "kinds")}}
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    kept = len(range(0, sz["wide_events"], 3))
    equal, totals_ok = True, True
    for i, m in enumerate(DASHBOARD_WIDE):
        a, b = wide["shared"]["fires"][i], wide["independent"]["fires"][i]
        equal = equal and len(a) > 0 and _fires_equal(a, b)
        per_record = 1 if m[0] == "tumbling" else m[1] // m[2]
        totals_ok = totals_ok and sum(int(f[3].sum()) for f in a) == kept * per_record
    wide_selected = (_shared_selected(wide["shared"]["kinds"], len(DASHBOARD_WIDE))
                     and wide["independent"]["kinds"].count("DeviceChainRunner")
                     == len(DASHBOARD_WIDE))
    out["leg2"] = {"events": sz["wide_events"], "keys": sz["wide_keys"],
                   "members": [list(m) for m in DASHBOARD_WIDE], "equal": equal,
                   "totals_ok": totals_ok, "selected": wide_selected,
                   "fires": [len(f) for f in wide["shared"]["fires"]],
                   **{name: {k: v[k] for k in ("seconds", "tuples_per_s", "k1_launches")}
                      for name, v in wide.items()}}
    del wide

    # ---- leg 3: latency mode ----
    n3 = sz["latency_events"]
    base = correlated_run(n3, True, columnar=True, sz=sz, dev=dev)
    lat = correlated_run(n3, True, columnar=True, latency=True, sz=sz, dev=dev)
    same = all(_fires_equal(correlated_fires(a), correlated_fires(b))
               for a, b in zip(base["sinks"], lat["sinks"]))
    out["leg3"] = {"events": n3, "rows_equal_throughput": same,
                   "throughput": {k: base[k] for k in ("seconds", "tuples_per_s", "k1_launches")},
                   "latency": {k: lat[k] for k in ("seconds", "tuples_per_s", "k1_launches")},
                   "selected": _shared_selected(lat["kinds"], len(DASHBOARD))}
    launched = all(x > 0 for x in (out["leg1"]["k1_launches"]["shared"],
                                   out["leg2"]["shared"]["k1_launches"],
                                   lat["k1_launches"]))
    out["ok"] = bool(parity and selected and equal and totals_ok and wide_selected and same
                     and out["leg3"]["selected"] and launched)
    return out


# ---------------------------------------------------------------------------
# phase 21: the million-key state plane (bench.py::millikey_microbench's
# program): hot/cold key tiering behind the fused operator
# ---------------------------------------------------------------------------

API_TIERED = dict(batch=8192, keys=10_000_000, hot=4096, admission=2, zipf_s=1.0,
                  parity_keys=1 << 15, parity_events=1 << 16, events=1 << 18, runs=1,
                  row_keys=1 << 20, row_slices=32, row_moves=1 << 16)


def _t_identity(col):
    return col


def tiered_job(n: int, n_keys: int, skewed: bool, sz, *, tiered: bool, cap: int, tmp: str,
               hook=None, extra=None, dev=DEV):
    """(env, sink) of millikey_microbench's program over n records of n_keys
    keys (uniform, or bounded zipf): a vectorized identity key_by (the host
    key dictionary's route), 10 s windows sliding by 1 s, count, batch
    sz["batch"]; with `tiered`, state.tier.* at hot capacity `cap` and
    sz["admission"], and the changelog on, their directories under tmp.
    `extra`: more options; hook(idx) runs before each source batch."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.sink import CollectSink
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    conf = {"execution.step.batch-size": sz["batch"],
            "execution.state.key-capacity": max(n_keys, 1024)}
    if tiered:
        conf.update({"state.tier.enabled": True, "state.tier.hot-key-capacity": cap,
                     "state.tier.admission-min-count": sz["admission"],
                     "state.tier.cold-dir": f"{tmp}/cold",
                     "state.changelog.enabled": True,
                     "state.changelog.dir": f"{tmp}/changelog"})
    conf.update(extra or {})
    env = StreamExecutionEnvironment(Configuration(conf), device=dev)

    def gen(idx):
        if hook is not None:
            hook(idx)
        return Batch(*st.millikey_columns(idx, n, n_keys, skewed, sz["zipf_s"]))

    sink = CollectSink()
    (env.from_source(DataGeneratorSource(gen, n),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by(_t_identity, vectorized=True)
     .window(SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS)).count().sink_to(sink))
    return env, sink


def tiered_run(n: int, n_keys: int, skewed: bool, sz, *, tiered: bool, cap: int,
               expect=None, extra=None, dev=DEV) -> dict:
    """One run of the program, built through the executor's JobRuntime
    (what env.execute() runs) so the operator is in reach, with K1's launch
    count at 0 just before it: its sorted (key, count) rows (or, given
    `expect`, whether they equal it and how many there were), seconds, K1
    launches and, when tiered, the tier's payload and store kind."""
    import shutil
    import tempfile

    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.executor import JobRuntime
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tier_")
    try:
        env, sink = tiered_job(n, n_keys, skewed, sz, tiered=tiered, cap=cap, tmp=tmp,
                               extra=extra, dev=dev)
        runtime = JobRuntime(plan(env._sinks), env.config, dev)
        ops = [r.op for r in runtime.runners
               if isinstance(getattr(r, "op", None), FusedWindowOperator)]
        _sync(dev)
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        runtime.run()
        _sync(dev)
        secs = time.perf_counter() - t0
        launches = cs.LAUNCHES["k1_superscan"]
        op = ops[0] if ops else None
        tier = op.tier_payload() if op is not None else None
        rows = sorted((int(k), int(c)) for k, c in sink.results)
        del sink.results[:]
        got = ({"rows": rows} if expect is None
               else {"equal": len(rows) > 0 and rows == expect, "num_rows": len(rows)})
        return {**got, "seconds": secs, "tuples_per_s": n / secs, "k1_launches": launches,
                "fused_selected": len(ops) == 1, "tier": tier,
                "native": None if tier is None else op.tier.cold.native,
                "state_key_count": op.state_key_count() if op is not None else None,
                "mesh_devices": op.mesh_devices() if op is not None else None}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tiered_row_surface(card: str, sz, dev=DEV) -> dict:
    """Leg C: the hot tier's row surface at card width, on a count ring and
    one float32 field ring of [S, K] = [row_slices, row_keys]. A demotion
    wave (gather_key_rows, then clear_key_rows, of row_moves random keys)
    and the promotion scatter back (write_cells of row_moves cells, then
    gather_cells of the same cells), each timed as the tier calls it (CUDA
    events, median of 5; ids up, rows down included) and as its device
    indexing alone, beside its bytes bound; every result and the rings after
    each call equal the same calls on CPU tensors."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms

    S, K, m = sz["row_slices"], sz["row_keys"], sz["row_moves"]
    window = SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS)
    g = torch.Generator().manual_seed(21)
    count0 = torch.randint(0, 64, (S, K), generator=g, dtype=torch.int32)
    sum0 = torch.randint(0, 1 << 20, (S, K), generator=g, dtype=torch.int32).float()
    pipes = {}
    for where in (dev, "cpu"):
        p = FusedWindowPipeline(window, "sum", key_capacity=K, num_slices=S, device=where)
        p._count.copy_(count0)
        p._state["sum"].copy_(sum0)
        pipes[where] = p
    del count0, sum0
    rng = np.random.default_rng(21)
    kids = rng.choice(K, m, replace=False).astype(np.int64)
    cell_kids = rng.choice(K, m, replace=False).astype(np.int64)
    cell_spos = rng.integers(0, S, m).astype(np.int64)
    counts = rng.integers(1, 1000, m).astype(np.int64)
    vals = rng.integers(0, 1 << 20, m).astype(np.float64)

    def rings_equal():
        a, b = pipes[dev], pipes["cpu"]
        return (torch.equal(a._count.cpu(), b._count)
                and torch.equal(a._state["sum"].cpu(), b._state["sum"]))

    equal = {}
    gd, gc = (pipes[w].gather_key_rows(kids) for w in (dev, "cpu"))
    equal["gather_key_rows"] = bool(gd[0].shape == (m, S) and np.array_equal(gd[0], gc[0])
                                    and np.array_equal(gd[1]["sum"], gc[1]["sum"]))
    for w in (dev, "cpu"):
        pipes[w].clear_key_rows(kids)
    equal["clear_key_rows"] = rings_equal()
    for w in (dev, "cpu"):
        pipes[w].write_cells(cell_kids, cell_spos, counts, {"sum": vals})
    equal["write_cells"] = rings_equal()
    cd, cc = (pipes[w].gather_cells(cell_kids, cell_spos) for w in (dev, "cpu"))
    equal["gather_cells"] = bool(np.array_equal(cd[0], cc[0]) and np.array_equal(cd[0], counts)
                                 and np.array_equal(cd[1]["sum"], cc[1]["sum"])
                                 and np.array_equal(cd[1]["sum"], vals.astype(np.float32)))
    del pipes["cpu"], gd, gc, cd, cc
    pipe = pipes[dev]
    k_d = torch.from_numpy(kids).to(dev)
    cell_d = (torch.from_numpy(cell_spos).to(dev), torch.from_numpy(cell_kids).to(dev))
    cnt_d = torch.from_numpy(counts.astype(np.int32)).to(dev)
    val_d = torch.from_numpy(vals.astype(np.float32)).to(dev)
    rings = (pipe._count, pipe._state["sum"])
    row_bytes = m * S * 8                     # one int32 and one float32 cell a slice
    calls = {
        "gather_key_rows": (lambda: pipe.gather_key_rows(kids),
                            lambda: [r.index_select(1, k_d) for r in rings],
                            m * 8 + 2 * row_bytes),
        "clear_key_rows": (lambda: pipe.clear_key_rows(kids),
                           lambda: [r.index_fill_(1, k_d, 0) for r in rings],
                           m * 8 + row_bytes),
        "write_cells": (lambda: pipe.write_cells(cell_kids, cell_spos, counts, {"sum": vals}),
                        lambda: [r.index_put_(cell_d, v) for r, v in zip(rings, (cnt_d, val_d))],
                        m * 16 + m * 8 + m * 8),
        "gather_cells": (lambda: pipe.gather_cells(cell_kids, cell_spos),
                         lambda: [r[cell_d] for r in rings],
                         m * 16 + 2 * m * 8),
    }
    out = {"phase": "api_tiered_row_surface", "card": card,
           "shape": f"[S, K] = [{S}, {K}] int32 count + float32 sum, {m} rows/cells",
           "equal_to_cpu": equal}
    for name, (call, device_only, nbytes) in calls.items():
        b_ms, b_by = bound(nbytes, 0)
        out[name] = {"ms": cuda_ms(call, 1), "device_ms": cuda_ms(device_only, 1),
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    out["ok"] = all(equal.values())
    return out


def api_tiered_phase(dev=DEV, sizes=None) -> dict:
    """The million-key state plane through the port's env.execute() path.

    A. parity at reduced cardinality (millikey_microbench's gate):
       parity_events records over parity_keys keys, hot capacity
       parity_keys // 8 (at most `hot`), uniform and zipf: the tiered job's
       rows equal, row for row, the untiered fused job's and the numpy
       oracle's, with evictions.
    B. full cardinality: `events` records over `keys` keys, hot capacity
       `hot`, admission `admission`, uniform and zipf: rows equal to the
       numpy oracle's, resident keys within the hot capacity, records routed
       cold, evictions under zipf (a uniform key occurs once, so the
       doorkeeper admits none), the cold tier on the native store; tuples/s
       best of `runs`, the tier's gauges and K1's launches.
    C. (on the card) the row surface at card width: tiered_row_surface.
    The tiered path emits in row mode (dense ids are recycled), one Python
    row per key and window."""
    from flink_tpu_torch.testing import stream as st

    sz = sizes or API_TIERED
    out = {"phase": "api_tiered", "batch": sz["batch"]}
    ok = True
    leg_a = {}
    for skewed, label in ((False, "uniform"), (True, "zipf")):
        n, p_keys = sz["parity_events"], min(sz["parity_keys"], sz["keys"])
        cap = min(sz["hot"], p_keys // 8)
        ref = tiered_run(n, p_keys, skewed, sz, tiered=False, cap=cap, dev=dev)
        got = tiered_run(n, p_keys, skewed, sz, tiered=True, cap=cap, dev=dev)
        oracle = st.millikey_oracle(n, p_keys, skewed, sz["zipf_s"])
        leg = {"events": n, "keys": p_keys, "hot_capacity": cap, "rows": len(got["rows"]),
               "parity_vs_untiered": len(got["rows"]) > 0 and got["rows"] == ref["rows"],
               "parity_vs_oracle": got["rows"] == oracle,
               "evictions": got["tier"]["evictions"],
               "promotions": got["tier"]["promotions"],
               "resident_keys": got["tier"]["residentKeys"],
               "k1_launches": {"tiered": got["k1_launches"], "untiered": ref["k1_launches"]},
               "fused_selected": got["fused_selected"] and ref["fused_selected"]}
        leg["ok"] = bool(leg["parity_vs_untiered"] and leg["parity_vs_oracle"]
                         and leg["evictions"] > 0 and leg["fused_selected"]
                         and got["k1_launches"] > 0 and ref["k1_launches"] > 0)
        ok = ok and leg["ok"]
        leg_a[label] = leg
        del ref, got, oracle
    out["leg_a"] = leg_a

    leg_b = {}
    for skewed, label in ((False, "uniform"), (True, "zipf")):
        n = sz["events"]
        oracle = st.millikey_oracle(n, sz["keys"], skewed, sz["zipf_s"])
        # each run's rows are held against the oracle and dropped: holding
        # millions of row tuples slows the next run's Python
        runs = [tiered_run(n, sz["keys"], skewed, sz, tiered=True, cap=sz["hot"],
                           expect=oracle, dev=dev) for _ in range(sz["runs"])]
        first, best = runs[0], min(runs, key=lambda r: r["seconds"])
        tier = first["tier"]
        leg = {"events": n, "keys": sz["keys"], "hot_capacity": sz["hot"],
               "admission_min_count": sz["admission"], "rows": first["num_rows"],
               "parity": all(r["equal"] for r in runs),
               "tuples_per_s": best["tuples_per_s"], "seconds": [r["seconds"] for r in runs],
               "resident_keys": tier["residentKeys"],
               "resident_bounded": tier["residentKeys"] <= sz["hot"],
               "evictions": tier["evictions"], "promotions": tier["promotions"],
               "vocab_size": tier["vocabSize"], "spilled_bytes": tier["spilledBytes"],
               "cold_records": tier["coldRecords"], "demoted_rows": tier["demotedRows"],
               "promoted_rows": tier["promotedRows"], "gauges": tier,
               "native": first["native"], "state_key_count": first["state_key_count"],
               "k1_launches": first["k1_launches"],
               "fused_selected": first["fused_selected"]}
        # every key of the uniform stream occurs once (events << keys), so
        # the doorkeeper admits none past the first `hot`: evictions are
        # zipf's gate, as in millikey_microbench's own test; both variants
        # must route records cold
        leg["ok"] = bool(leg["parity"] and leg["resident_bounded"] and leg["native"]
                         and leg["cold_records"] > 0 and leg["fused_selected"]
                         and leg["k1_launches"] > 0 and (not skewed or leg["evictions"] > 0))
        ok = ok and leg["ok"]
        leg_b[label] = leg
        del runs, oracle, first, best
    out["leg_b"] = leg_b
    out["ok"] = bool(ok)
    return out


def tiered_k1_inputs(skewed: bool, sz=API_TIERED, dev=DEV):
    """K1's inputs of leg B's first full dispatch (zipf or uniform keys): the
    tiered operator at the executor's geometry (hot capacity, 32 steps,
    chunk 4096) fed the stream's batches and watermarks as the runner feeds
    them, up to its first 32-step dispatch, else its widest (evictions
    flush the operator, and a flush dispatches the steps it holds). Cold
    records ride it as kid -1. Returns (pipe, agg, idx, vals, plan)."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
    from flink_tpu_torch.state.tier_manager import TierConfig
    from flink_tpu_torch.testing import stream as st

    op = FusedWindowOperator(
        SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS), "count",
        key_capacity=sz["hot"], superbatch_steps=32, chunk=4096,
        tier=TierConfig(hot_key_capacity=sz["hot"], admission_min_count=sz["admission"]),
        device=dev)
    staged = []
    stage = op.pipe.stage_superbatch

    def keep_widest(batches, watermarks):
        res = stage(batches, watermarks)
        if not staged or len(batches) > int(staged[0][2][0].shape[0]):
            staged[:] = [res]
        return res

    op.pipe.stage_superbatch = keep_widest
    n, B = sz["events"], sz["batch"]
    for lo in range(0, n, B):
        if staged and int(staged[0][2][0].shape[0]) == 32:
            break
        keys, ts = st.millikey_columns(np.arange(lo, min(lo + B, n), dtype=np.int64), n,
                                       sz["keys"], skewed, sz["zipf_s"])
        op.process_batch(keys, np.zeros(len(ts), np.float32), ts)
        op.process_watermark(int(ts.max()) - 1)
    idx, vals, plan = staged[0]
    return op.pipe, resolve("count"), idx, vals, plan


# ---------------------------------------------------------------------------
# phase 22: job checkpoints, restart strategies and savepoints through
# env.execute_async on the port's MiniCluster
# ---------------------------------------------------------------------------

# leg A: api_ysb's program (filter one in three, key, 10 s / 1 s count, 8192
# keys, batch 65536) over 2^21 records, one host failure in the sink at 60%
# of the stream's event time, checkpoints at 1 ms (every step) and 25 ms
# (checkpoint_microbench's interval); leg B: the same program at 2^20 keys
# with a float32 sum (rings [32, 2^20] x 2 = 256 MiB), checkpoints every
# 40 ms, then a savepoint at half the input, cancel, resume; leg C:
# api_tiered's zipf job (2^17 records over 10^7 keys) with a checkpoint at
# every step and one host failure in the source (at 2^16 its incremental
# ratio, 0.255, misses the 0.25 gate; 2^17 gave 0.197, 2^18 0.170)
API_CHECKPOINT = dict(keys=8192, batch=65536, events=1 << 21, warmup_events=1 << 18,
                      intervals=(1, 25), fail_at=0.6, mem_slack=1 << 19,
                      big_keys=1 << 20, big_events=1 << 22, big_interval=40,
                      min_checkpoints=4, savepoint_at=0.5, tiered_events=1 << 17)


class FailOnceSink:
    """A sink around `inner` whose writers raise once, on the first batch
    whose largest timestamp reaches `fail_ts` (None: never), and log the
    device memory allocated at each writer's first batch (one writer an
    attempt): `.first_write_bytes`."""

    def __init__(self, inner, fail_ts=None):
        self.inner, self.fail_ts, self.failed = inner, fail_ts, False
        self.first_write_bytes = []

    def create_writer(self):
        from flink_tpu_torch.connectors.sink import SinkWriter

        sink, inner = self, self.inner.create_writer()

        class Writer(SinkWriter):
            first = True

            def write_batch(self, values, timestamps=None):
                if self.first:
                    self.first = False
                    sink.first_write_bytes.append(
                        torch.cuda.memory_allocated() if torch.cuda.is_available() else 0)
                if (sink.fail_ts is not None and not sink.failed and len(timestamps)
                        and int(np.max(timestamps)) >= sink.fail_ts):
                    sink.failed = True
                    raise RuntimeError("injected host failure in the sink writer")
                inner.write_batch(values, timestamps)

            def prepare_commit(self, epoch_id="final"):
                return inner.prepare_commit(epoch_id)

            def close(self):
                inner.close()

            def __getattr__(self, name):     # a collecting writer's `store`
                return getattr(inner, name)

        return Writer()

    def create_committer(self):
        return self.inner.create_committer()


def timed_collect_sink():
    """A collecting sink (its writer's `store` rides each checkpoint, as
    CollectSink's does) keeping each row with its timestamp (a window's max
    timestamp): `.results` of (row, ts)."""
    from flink_tpu_torch.connectors.sink import Sink, SinkWriter

    class Writer(SinkWriter):
        def __init__(self, store):
            self.store = store

        def write_batch(self, values, timestamps=None):
            self.store.extend(zip(values, (int(t) for t in timestamps)))

    class TimedCollectSink(Sink):
        def __init__(self):
            self.results = []

        def create_writer(self):
            return Writer(self.results)

    return TimedCollectSink()


def ckpt_job(n: int, sink, sz, *, interval: int = 0, chk_dir=None, keys=None, agg="count",
             columnar=False, hook=None, conf=None, dev=DEV):
    """env of the api_ysb program over n records with execution.checkpointing
    at `interval` ms (0: off) into chk_dir, restart-strategy fixed-delay with
    a 1 ms backoff; `agg` "sum" sums the payload column into a float32
    field beside the count ring; hook(idx) runs before each source batch
    (gates); `conf` adds options (the mesh's)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    keys = keys or sz["keys"]
    opts = {"execution.step.batch-size": sz["batch"], "execution.state.key-capacity": keys,
            "execution.window.columnar-output": columnar,
            "restart-strategy.type": "fixed-delay", "restart-strategy.initial-backoff": 1}
    if interval:
        opts.update({"execution.checkpointing.interval": interval,
                     "execution.checkpointing.dir": chk_dir})
    opts.update(conf or {})
    env = StreamExecutionEnvironment(Configuration(opts), device=dev)

    def gen(idx):
        if hook is not None:
            hook(idx)
        return Batch(*st.api_columns(idx, n, keys, payload=agg == "sum"))

    win = (env.from_source(DataGeneratorSource(gen, n),
                           WatermarkStrategy.for_bounded_out_of_orderness(0))
           .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
           .window(SlidingEventTimeWindows.of(API["window"], API["slide"])))
    if agg == "sum":
        win.aggregate("sum", value_fn=_t_value, value_traceable=True).sink_to(sink)
    else:
        win.aggregate("count").sink_to(sink)
    return env


def ckpt_run(env, dev=DEV, timeout=900, name=None, hold=None) -> dict:
    """One execute_async() with K1's launch counts at 0 just before it: the
    client, seconds and K1 launches (the lane entry; the partials entry's
    as `k1_partials`). hold(client) runs while the job runs (a drill at a
    source gate), if given."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    client = env.execute_async(name)
    if hold is not None:
        hold(client)
    client.wait(timeout)
    _sync(dev)
    return {"client": client, "seconds": time.perf_counter() - t0,
            "k1_launches": cs.LAUNCHES["k1_superscan"],
            "k1_partials": cs.LAUNCHES["k1_partials"]}


def ckpt_stats(client) -> dict:
    """What a run's client says of its status, checkpoints and restarts, and
    of its first recovery: downtime (failure caught to RUNNING), the part of
    it spent releasing the failed attempt, and each failure's injected
    attribution."""
    g = client.checkpoint_stats.gauge_values()
    restored = client.checkpoint_stats.payload()["latest"]["restored"]
    exc = client.exceptions.payload()
    rec = exc["recoveries"][0] if exc["recoveries"] else {}
    return {"status": client.status().value, "num_restarts": client.num_restarts,
            "checkpoints": g["numberOfCompletedCheckpoints"],
            "lastCheckpointDuration_ms": g["lastCheckpointDuration"],
            "lastCheckpointSize_bytes": g["lastCheckpointSize"],
            "restored_checkpoint_id": None if restored is None else restored["checkpoint_id"],
            "restore_ms": None if restored is None else restored["restore_duration_ms"],
            "downtime_ms": rec.get("downtime_ms"), "release_ms": rec.get("release_ms"),
            "injected": [e["injected"] for e in exc["entries"]]}


class SourceGate:
    """A job's source hook that holds it at a gate: it blocks the source at
    the first batch from record `at` until `go`, and with `hold_at` blocks
    it again at the batch starting there until `taken`, so the job cannot
    finish before the caller has cancelled it."""

    def __init__(self, at: int, hold_at=None):
        import threading

        self.at, self.hold_at, self._fired = at, hold_at, False
        self.reached, self.go, self.taken = (threading.Event() for _ in range(3))

    def __call__(self, idx):
        if not self._fired and idx[0] >= self.at:
            self._fired = True
            self.reached.set()
            self.go.wait(600)
        elif self.hold_at is not None and idx[0] == self.hold_at:
            self.taken.wait(600)

    def savepoint(self, client, path: str) -> dict:
        """Once the source is at the gate, a savepoint of the job into
        `path` (the request is in before the source moves on), then the
        job cancelled: {"first_job": its final status, "trigger_ms": the
        savepoint's wall time}."""
        import threading

        self.reached.wait(600)
        took = {}

        def take():
            t0 = time.perf_counter()
            client.trigger_savepoint(path, timeout=600)
            took["ms"] = (time.perf_counter() - t0) * 1e3

        writer = threading.Thread(target=take)
        writer.start()
        while client._savepoint_path is None and writer.is_alive():
            time.sleep(0.001)
        self.go.set()
        writer.join(600)
        client.cancel()
        self.taken.set()
        return {"first_job": client.wait(600).value, "trigger_ms": took.get("ms")}


def timed_fired(results, keys: int, twice: bool = False):
    """(row, ts) results in row mode as {window index: row over the keys};
    with `twice`, also whether any key of a window came twice."""
    fired, seen_twice = {}, False
    for (k, v), t in results:
        j = (int(t) + 1 - API["window"]) // API["slide"]
        row = fired.get(j)
        if row is None:
            row = fired[j] = np.zeros(keys)
        seen_twice = seen_twice or row[int(k)] != 0
        row[int(k)] = v
    return (fired, seen_twice) if twice else fired


def columnar_fired(results, keys: int):
    """Columnar (packed) results as {window index: row over the keys}, and
    whether any window came twice."""
    fired, twice = {}, False
    for (window, ids, vals), _t in results:
        j = (window.max_timestamp() + 1 - API["window"]) // API["slide"]
        twice = twice or j in fired
        row = fired[j] = np.zeros(keys)
        row[np.asarray(ids)] = np.asarray(vals)
    return fired, twice


def ckpt_leg_a(sz, dev, tmp: str) -> dict:
    """Exactly-once recovery on the main path (see API_CHECKPOINT)."""
    import collections
    import os

    from flink_tpu_torch.connectors.sink import FileSink
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["events"], sz["keys"]
    fail_ts = st.API_T0_MS + int(st.API_SPAN_EVENT_MS * sz["fail_at"])
    ref = st.api_replay(n, sz["batch"], agg="count", num_keys=keys)
    ckpt_run(ckpt_job(sz["warmup_events"], timed_collect_sink(), sz, dev=dev), dev)
    off_sink = timed_collect_sink()
    off = ckpt_run(ckpt_job(n, off_sink, sz, dev=dev), dev)
    rows = sorted(off_sink.results)
    oracle_ok, checked = st.parity(ref.fired, timed_fired(off_sink.results, keys))
    out = {"events": n, "keys": keys, "batch": sz["batch"],
           "off": {"seconds": off["seconds"], "tuples_per_s": n / off["seconds"],
                   "k1_launches": off["k1_launches"], "rows": len(rows),
                   "parity_vs_oracle": oracle_ok, "windows_checked": checked}}
    ok = oracle_ok and off["k1_launches"] > 0
    del off_sink
    for interval in sz["intervals"]:
        leg = {}
        if interval == sz["intervals"][-1]:
            # checkpoints on, no failure: the overhead
            sink = timed_collect_sink()
            on = ckpt_run(ckpt_job(n, sink, sz, interval=interval,
                                   chk_dir=f"{tmp}/on{interval}", dev=dev), dev)
            leg = {"seconds": on["seconds"], "tuples_per_s": n / on["seconds"],
                   "overhead_pct": 100.0 * (on["seconds"] / off["seconds"] - 1.0),
                   "k1_launches": on["k1_launches"],
                   "rows_equal": sorted(sink.results) == rows, **ckpt_stats(on["client"])}
            ok = ok and leg["rows_equal"] and on["k1_launches"] > 0 and leg["checkpoints"] > 0
            del sink
        # one host failure in the sink at fail_at of the event time
        fsink = FailOnceSink(timed_collect_sink(), fail_ts)
        rec = ckpt_run(ckpt_job(n, fsink, sz, interval=interval,
                                chk_dir=f"{tmp}/fail{interval}", dev=dev), dev)
        client = rec["client"]
        got = sorted(fsink.inner.results)
        par, _c = st.parity(ref.fired, timed_fired(fsink.inner.results, keys))
        mem = fsink.first_write_bytes
        leg["recovery"] = {
            "status": client.status().value, "seconds": rec["seconds"],
            "k1_launches": rec["k1_launches"], **ckpt_stats(client),
            "rows_equal": got == rows, "parity_vs_oracle": par,
            "fused_selected": any(type(r).__name__ == "DeviceChainRunner"
                                  for r in client._runtime.runners),
            "first_write_allocated_bytes": mem,
            "memory_bounded": len(mem) == 2 and mem[1] <= mem[0] + sz["mem_slack"]}
        r = leg["recovery"]
        leg["ok"] = bool(r["status"] == "FINISHED" and r["num_restarts"] == 1
                         and r["restored_checkpoint_id"] is not None and r["rows_equal"]
                         and r["parity_vs_oracle"] and r["fused_selected"]
                         and r["memory_bounded"] and r["k1_launches"] > 0)
        ok = ok and leg["ok"]
        out[f"interval_{interval}ms"] = leg
        del fsink, got, client, rec
    # the same job into a FileSink: committed part files hold the rows once
    interval = sz["intervals"][-1]
    fdir = f"{tmp}/filesink"
    fsink = FailOnceSink(FileSink(fdir, prefix="out"), fail_ts)
    rec = ckpt_run(ckpt_job(n, fsink, sz, interval=interval, chk_dir=f"{tmp}/file{interval}",
                            dev=dev), dev)
    lines = []
    parts = sorted(p for p in os.listdir(fdir) if not p.startswith("."))
    for p in parts:
        with open(os.path.join(fdir, p)) as f:
            lines += [ln for ln in f.read().splitlines() if ln]
    want = collections.Counter(str(row) for row, _t in rows)
    out["file_sink"] = {"interval_ms": interval, "part_files": len(parts),
                        "lines": len(lines), "num_restarts": rec["client"].num_restarts,
                        "lines_equal_rows": collections.Counter(lines) == want,
                        "k1_launches": rec["k1_launches"]}
    ok = (ok and out["file_sink"]["lines_equal_rows"] and rec["client"].num_restarts == 1
          and rec["k1_launches"] > 0)
    out["ok"] = bool(ok)
    return out


def pinned_copy_ms(nbytes: int) -> dict:
    """One large copy_ each way between the card and pinned host memory:
    the bandwidths the capture and restore bounds use."""
    from flink_tpu_torch.testing.timing import cuda_ms

    d = torch.empty(nbytes // 4, dtype=torch.int32, device=DEV)
    h = torch.empty(nbytes // 4, dtype=torch.int32, pin_memory=True)
    d2h = cuda_ms(lambda: h.copy_(d, non_blocking=True), 3)
    h2d = cuda_ms(lambda: d.copy_(h, non_blocking=True), 3)
    del d, h
    return {"bytes": nbytes, "d2h_ms": d2h, "h2d_ms": h2d,
            "d2h_bytes_per_s": nbytes / d2h * 1e3, "h2d_bytes_per_s": nbytes / h2d * 1e3}


def capture_parts(pipe, store_dir: str, dev=DEV) -> dict:
    """The capture and restore of `pipe`'s rings by part, against bounds:
    the on-card transposition to the canonical [K, S] form (CUDA events;
    bound: each ring read and written once over the memory rate), the copy
    to the host (host clock, synchronised; bound: the bytes over the
    pinned device-to-host rate one large copy_ gives in this run), pickle
    and fsync (FsCheckpointStorage.save's own parts), the load, and the
    restore's copy to the card (bound: the pinned host-to-device rate, plus
    the transposition back)."""
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.testing.timing import cuda_ms

    rings = [pipe._count] + [pipe._state[k] for k in sorted(pipe._state)]
    nbytes = sum(r.numel() * r.element_size() for r in rings)
    copy = pinned_copy_ms(nbytes) if torch.device(dev).type == "cuda" else None
    transpose_ms = (cuda_ms(lambda: [cs.from_kernel_layout(r).contiguous() for r in rings], 3)
                    if copy is not None else None)
    _sync(dev)
    t0 = time.perf_counter()
    snap = pipe.snapshot()
    _sync(dev)
    snapshot_s = time.perf_counter() - t0
    store = FsCheckpointStorage(store_dir)
    store.save(1, {"pipe": snap})
    parts = store.last_save_parts
    t0 = time.perf_counter()
    loaded = store.load(store.latest()[1])
    load_s = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    pipe.restore(loaded["pipe"])
    _sync(dev)
    restore_s = time.perf_counter() - t0
    out = {"ring_bytes": nbytes, "file_bytes": parts["bytes"],
           "snapshot_ms": snapshot_s * 1e3, "transpose_ms": transpose_ms,
           "pickle_ms": parts["pickle_s"] * 1e3, "fsync_ms": parts["fsync_s"] * 1e3,
           "load_ms": load_s * 1e3, "restore_ms": restore_s * 1e3}
    if copy is not None:
        # transposition: read and write each ring once on the card
        t_bytes = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        out.update(pinned_copy=copy,
                   snapshot_bound_ms=nbytes / copy["d2h_bytes_per_s"] * 1e3 + t_bytes,
                   restore_bound_ms=nbytes / copy["h2d_bytes_per_s"] * 1e3 + t_bytes,
                   transpose_bound_ms=t_bytes)
        out["leading_part"] = ("transpose" if transpose_ms > out["snapshot_ms"] / 2
                               else "copy to host")
    return out


def ckpt_leg_b(sz, dev, tmp: str) -> dict:
    """Keyed state at card size (see API_CHECKPOINT): a checkpointed run,
    the capture and restore by part, then savepoint, cancel and resume."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.minicluster import MiniCluster
    from flink_tpu_torch.testing import stream as st

    n, keys, B = sz["big_events"], sz["big_keys"], sz["batch"]
    ref = st.api_replay(n, B, agg="sum", num_keys=keys)
    sink = timed_collect_sink()
    run = ckpt_run(ckpt_job(n, sink, sz, interval=sz["big_interval"], chk_dir=f"{tmp}/big",
                            keys=keys, agg="sum", columnar=True, dev=dev), dev)
    fired, twice = columnar_fired(sink.results, keys)
    par, checked = st.parity(ref.fired, fired)
    stats = ckpt_stats(run["client"])
    op = next(r.op for r in run["client"]._runtime.runners if hasattr(r, "op"))
    out = {"events": n, "keys": keys, "interval_ms": sz["big_interval"],
           "ring_shape": [int(op.pipe.S), int(op.pipe.K)], "seconds": run["seconds"],
           "k1_launches": run["k1_launches"], **stats, "parity_vs_oracle": par,
           "windows_checked": checked, "no_window_twice": not twice}
    out["capture"] = capture_parts(op.pipe, f"{tmp}/parts", dev)
    del sink, fired, op, run
    # savepoint at savepoint_at of the input, cancel, resume as a new job
    half = (int(n * sz["savepoint_at"]) // B) * B
    gate = SourceGate(half, hold_at=half + 2 * B)
    sink1 = timed_collect_sink()
    env1 = ckpt_job(n, sink1, sz, keys=keys, agg="sum", columnar=True, hook=gate, dev=dev)
    sp_path = f"{tmp}/savepoint"
    first = gate.savepoint(env1.execute_async("leg-b-savepoint"), sp_path)
    sink2 = timed_collect_sink()
    env2 = ckpt_job(n, sink2, sz, keys=keys, agg="sum", columnar=True, hook=gate, dev=dev)
    from flink_tpu_torch.ops import cuda_superscan as cs

    cs.reset_launch_counts()
    t0 = time.perf_counter()
    client2 = MiniCluster.get_shared().submit(plan(env2._sinks), env2.config, "leg-b-resumed",
                                              savepoint_restore_path=sp_path, device=dev)
    status2 = client2.wait(900)
    _sync(dev)
    fired2, twice2 = columnar_fired(sink2.results, keys)
    par2, checked2 = st.parity(ref.fired, fired2)
    out["savepoint"] = {
        "at_record": half, **first, "resumed_job": status2.value,
        "resume_seconds": time.perf_counter() - t0,
        "records_in": client2.records_in, "records_in_complete": client2.records_in == n,
        "rows_before_savepoint": len(sink1.results), "parity_vs_oracle": par2,
        "windows_checked": checked2, "no_window_twice": not twice2,
        "k1_launches": cs.LAUNCHES["k1_superscan"],
        "restore_ms": client2.checkpoint_stats.payload()["latest"]["restored"][
            "restore_duration_ms"]}
    s = out["savepoint"]
    out["ok"] = bool(par and not twice and out["checkpoints"] >= sz["min_checkpoints"]
                     and out["k1_launches"] > 0 and first["first_job"] == "CANCELED"
                     and status2.value == "FINISHED" and s["records_in_complete"]
                     and par2 and not twice2 and s["k1_launches"] > 0)
    return out


def ckpt_leg_c(sz, dev, tmp: str) -> dict:
    """Incremental checkpoints of the tiered job (api_tiered leg B's zipf
    job through the coordinator, a checkpoint at every step, one host
    failure in the source at fail_at): rows equal numpy's after the restore
    from the changelog handle; incremental_ratio as millikey_microbench
    computes it (median interval changelog bytes over the base bytes)."""
    import statistics

    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
    from flink_tpu_torch.testing import stream as st

    tz = API_TIERED
    n = sz["tiered_events"]
    state = {"failed": False}

    def hook(idx):
        if not state["failed"] and idx[0] >= int(n * sz["fail_at"]):
            state["failed"] = True
            raise RuntimeError("injected host failure in the source")

    env, sink = tiered_job(n, tz["keys"], True, tz, tiered=True, cap=tz["hot"], tmp=tmp,
                           hook=hook, dev=dev,
                           extra={"execution.checkpointing.interval": 1,
                                  "execution.checkpointing.dir": f"{tmp}/chk",
                                  "restart-strategy.type": "fixed-delay",
                                  "restart-strategy.initial-backoff": 1})
    run = ckpt_run(env, dev)
    client = run["client"]
    op = next(r.op for r in client._runtime.runners
              if isinstance(getattr(r, "op", None), FusedWindowOperator))
    tier = op.tier
    med = statistics.median(tier.interval_bytes_history)
    base = tier.last_base_bytes()
    rows = sorted((int(k), int(c)) for k, c in sink.results)
    oracle = st.millikey_oracle(n, tz["keys"], True, tz["zipf_s"])
    stats = ckpt_stats(client)
    out = {"events": n, "keys": tz["keys"], "hot_capacity": tz["hot"],
           "seconds": run["seconds"], "k1_launches": run["k1_launches"], **stats,
           "rows": len(rows), "parity_vs_oracle": rows == oracle,
           "changelog_interval_bytes_p50": med, "base_bytes": base,
           "incremental_ratio": med / max(base, 1),
           "interval_checkpoints": len(tier.interval_bytes_history),
           "evictions": op.tier_payload()["evictions"]}
    out["ok"] = bool(out["parity_vs_oracle"] and out["incremental_ratio"] < 0.25
                     and out["num_restarts"] == 1 and out["restored_checkpoint_id"] is not None
                     and out["k1_launches"] > 0)
    return out


def ckpt_main_thread_run(sz=API_CHECKPOINT, interval: int = 25, dev=DEV) -> float:
    """Leg A's job with checkpoints at `interval` ms, driven on the calling
    thread (JobRuntime.run under a CheckpointCoordinator into a temporary
    directory, as the MiniCluster's job thread drives it), so cProfile,
    which sees only the thread that started it, sees the job: seconds."""
    import shutil
    import tempfile

    from flink_tpu_torch.checkpoint import CheckpointCoordinator, FsCheckpointStorage
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import JobRuntime

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_profile_")
    try:
        env = ckpt_job(sz["events"], timed_collect_sink(), sz, dev=dev)
        runtime = JobRuntime(plan(env._sinks), env.config, dev)
        coordinator = CheckpointCoordinator(FsCheckpointStorage(tmp), interval)
        _sync(dev)
        t0 = time.perf_counter()
        runtime.run(coordinator=coordinator)
        _sync(dev)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def api_checkpoint_phase(dev=DEV, sizes=None) -> dict:
    """Phase 22: legs A, B and C (see API_CHECKPOINT), each through
    env.execute_async on the MiniCluster."""
    import shutil
    import tempfile

    sz = sizes or API_CHECKPOINT
    out = {"phase": "api_checkpoint"}
    for leg, fn in (("leg_a", ckpt_leg_a), ("leg_b", ckpt_leg_b), ("leg_c", ckpt_leg_c)):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_ckpt_{leg}_")
        t0 = time.perf_counter()
        try:
            out[leg] = fn(sz, dev, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out[leg]["leg_s"] = time.perf_counter() - t0
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    out["ok"] = bool(all(out[leg]["ok"] for leg in ("leg_a", "leg_b", "leg_c")))
    return out


# ---------------------------------------------------------------------------
# phase 23: api_join, two-input joins (bench.py::join_microbench's NEXMark
# q3 and q8) through the port's API, on the device join ring and the host
# ---------------------------------------------------------------------------

API_JOIN = dict(keys=2048, batch=1024, events=1 << 14, zipf_s=1.0,
                big_keys=1 << 16, big_events=1 << 20, runs=1,
                degrade_slots=16, degrade_keys=1024, sql_rows=4096, regular_rows=512,
                ckpt_events=1 << 16, interval=25, fail_at=0.6, mem_slack=1 << 19)
# scenario -> (window size ms, slide ms, the auctions' category filter)
JOIN_SCENARIOS = {"q3": (2000, 1000, True), "q8": (1000, 1000, False)}
SQL_Q8 = ("SELECT p.id, p.name, a.itemid FROM person AS p "
          "JOIN auction AS a ON p.id = a.seller WINDOW TUMBLE(INTERVAL '1' SECOND)")
SQL_FULL = ("SELECT p.id, a.itemid FROM person AS p FULL OUTER JOIN "
            "auction AS a ON p.id = a.seller")
SQL_REGULAR = {"inner": "SELECT p.id, p.name, a.itemid FROM person AS p "
                        "JOIN auction AS a ON p.id = a.seller",
               "left": "SELECT p.id, p.name, a.itemid FROM person AS p "
                       "LEFT OUTER JOIN auction AS a ON p.id = a.seller"}


def join_env(n: int, scenario: str, sz, *, skewed=False, keys=None, device_joins=True,
             sink=None, conf=None, dev=DEV):
    """(env, sink) of bench.py::join_microbench's build(): persons JOIN
    auctions ON key (q3: the auctions' category filter, 2 s windows sliding
    by 1 s; q8: 1 s tumbling), emitting (key, person name, auction name),
    n records a side over `keys` keys (the key capacity too, unless `conf`
    sets it)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    keys = keys or sz["keys"]
    cfg = {"execution.step.batch-size": sz["batch"], "execution.state.key-capacity": keys,
           "execution.join.device-enabled": device_joins}
    cfg.update(conf or {})
    env = StreamExecutionEnvironment(Configuration(cfg), device=dev)

    def source(side):
        return DataGeneratorSource(
            lambda idx: Batch(*st.join_rows(idx, n, side, keys, skewed, sz["zipf_s"])), n)

    wm = WatermarkStrategy.for_bounded_out_of_orderness(0)
    persons = env.from_source(source("p"), wm)
    auctions = env.from_source(source("a"), wm)
    size, slide, filtered = JOIN_SCENARIOS[scenario]
    if filtered:
        auctions = auctions.filter(lambda r: r[2] == 0)
    joined = (persons.join(auctions).where(lambda r: r[0]).equal_to(lambda r: r[0])
              .window(SlidingEventTimeWindows.of(size, slide))
              .apply(lambda p, a: (p[0], p[1], a[1])))
    if sink is None:
        return env, joined.collect()
    joined.sink_to(sink)
    return env, sink


def join_run(env, dev=DEV) -> dict:
    """One run of a join job through JobRuntime (so the runner stays
    inspectable), B5's program calls counted from 0 just before it: the
    seconds (runtime build included, as env.execute()), the join runner,
    the calls."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import join_ring
    from flink_tpu_torch.runtime.executor import JobRuntime

    _sync(dev)
    join_ring.reset_call_counts()
    t0 = time.perf_counter()
    rt = JobRuntime(plan(env._sinks), env.config, dev)
    rt.run()
    _sync(dev)
    secs = time.perf_counter() - t0
    (runner,) = [r for r in rt.runners
                 if type(r).__name__ in ("DeviceJoinRunner", "WindowJoinRunner")]
    return {"seconds": secs, "runner": runner, "calls": dict(join_ring.CALLS)}


def _join_on_device(d: dict, dev) -> bool:
    """The device route ran: the runner is the DeviceJoinRunner, its rings
    are on `dev`, and B5's ingest and match ran."""
    r = d["runner"]
    return bool(type(r).__name__ == "DeviceJoinRunner" and r.pipeline is not None
                and r.pipeline.left.idx_arr.device.type == torch.device(dev).type
                and d["calls"]["join_ingest"] > 0 and d["calls"]["join_match"] > 0)


def join_leg_a(sz, dev) -> dict:
    """q3 and q8, uniform and zipf, at the bench's defaults: the device
    route's rows against the host route's and the numpy model's."""
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["events"], sz["keys"]
    out, ok = {}, True
    for scenario, (size, slide, filtered) in JOIN_SCENARIOS.items():
        for label, skewed in (("uniform", False), ("zipf", True)):
            model = st.join_model(n, keys, skewed, size, slide, auction_filter=filtered,
                                  zipf_s=sz["zipf_s"])
            env, sink = join_env(n, scenario, sz, skewed=skewed, dev=dev)
            d = join_run(env, dev)
            envh, sinkh = join_env(n, scenario, sz, skewed=skewed, device_joins=False, dev=dev)
            h = join_run(envh, dev)
            rows, rows_h = st.join_row_ids(sink.results), st.join_row_ids(sinkh.results)
            r = d["runner"]
            leg = {"rows": len(rows), "equals_host": bool(np.array_equal(rows, rows_h)),
                   "equals_model": bool(np.array_equal(rows, model)),
                   "device_selected": type(r).__name__ == "DeviceJoinRunner",
                   "host_runner": type(h["runner"]).__name__,
                   "fallback_reason": getattr(r, "fallback_reason", "n/a"),
                   "final_K_C": [r.geom.key_capacity, r.geom.bucket_capacity],
                   "program_calls": d["calls"], "device_s": d["seconds"], "host_s": h["seconds"]}
            leg["ok"] = bool(leg["equals_host"] and leg["equals_model"] and len(rows) > 0
                             and _join_on_device(d, dev) and r.fallback_reason is None
                             and leg["host_runner"] == "WindowJoinRunner"
                             and (not skewed or r.geom.bucket_capacity > 16))
            ok = ok and leg["ok"]
            out[f"{scenario}_{label}"] = leg
    out["ok"] = bool(ok)
    return out


def join_leg_b(sz, dev) -> dict:
    """q8 uniform at the key capacity's default, 2^16 keys, 2^20 records a
    side: parity with the host route and the model with ~1.09 GB of rings
    on the card, tuples/s of both routes (best of `runs`, one in the
    smoke)."""
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["big_events"], sz["big_keys"]
    t0 = time.perf_counter()
    model = st.join_model(n, keys, False, 1000, 1000)
    model_s = time.perf_counter() - t0
    dev_s, host_s = [], []
    out = {"events_per_side": n, "keys": keys, "batch": sz["batch"], "model_s": model_s}
    cuda = torch.device(dev).type == "cuda"
    for i in range(sz["runs"]):
        env, sink = join_env(n, "q8", sz, keys=keys, dev=dev)
        if cuda:
            # the rings' footprint: allocations of this run over what the
            # process (earlier phases) already held
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        d = join_run(env, dev)
        dev_s.append(d["seconds"])
        if i == 0:
            r = d["runner"]
            g = r.geom
            out.update(
                geometry={"NB": g.ring_buckets, "K": g.key_capacity, "C": g.bucket_capacity},
                state_bytes=r.state_bytes(), fallback_reason=r.fallback_reason,
                on_device=_join_on_device(d, dev), program_calls=d["calls"],
                matches=r.matches_emitted,
                memory_allocated_delta=torch.cuda.memory_allocated() - before if cuda else 0,
                peak_allocated_delta=torch.cuda.max_memory_allocated() - before if cuda else 0)
            rows = st.join_row_ids(sink.results)
        del env, sink, d
        envh, sinkh = join_env(n, "q8", sz, keys=keys, device_joins=False, dev=dev)
        h = join_run(envh, dev)
        host_s.append(h["seconds"])
        if i == 0:
            rows_h = st.join_row_ids(sinkh.results)
        del envh, sinkh, h
    out.update(rows=len(rows), equals_host=bool(np.array_equal(rows, rows_h)),
               equals_model=bool(np.array_equal(rows, model)),
               device_seconds=dev_s, host_seconds=host_s,
               device_tuples_per_s=2 * n / min(dev_s), host_tuples_per_s=2 * n / min(host_s))
    expect_bytes = 2 * 2 * 4 * out["geometry"]["NB"] * keys * out["geometry"]["C"]
    out["ok"] = bool(out["equals_host"] and out["equals_model"] and out["on_device"]
                     and out["fallback_reason"] is None and out["rows"] > 0
                     and out["geometry"]["K"] == keys and out["state_bytes"] == expect_bytes)
    return out


def join_sql_env(sz, rows: int, *, device_joins=True, fusion=True, dev=DEV):
    """(env, tenv, (person keys, auction keys, timestamps)) of
    bench.py::join_microbench's SQL block: person(id, name, ptime) and
    auction(seller, itemid, atime) with zipf keys."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.table.table_env import TableEnvironment, TableSchema
    from flink_tpu_torch.testing import stream as st

    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": sz["batch"], "execution.join.device-enabled": device_joins,
        "table.device-fusion": fusion}), device=dev)
    tenv = TableEnvironment(env)
    idx = np.arange(rows)
    pk = st.zipf_keys(idx, sz["keys"], sz["zipf_s"])
    ak = st.zipf_keys(idx + rows, sz["keys"], sz["zipf_s"])
    ts = (10_000 + idx * 64_000 // rows).astype(np.int64)
    tenv.from_rows("person", [{"id": int(k), "name": f"p{i}", "ptime": int(t)}
                              for i, (k, t) in enumerate(zip(pk, ts))],
                   TableSchema(["id", "name", "ptime"], rowtime="ptime"))
    tenv.from_rows("auction", [{"seller": int(k), "itemid": f"a{i}", "atime": int(t)}
                               for i, (k, t) in enumerate(zip(ak, ts))],
                   TableSchema(["seller", "itemid", "atime"], rowtime="atime"))
    return env, tenv, (pk, ak, ts)


def join_sql_model(pk, ak, ts, kind: str) -> list:
    """Rows of the SQL join over the tables' columns, sorted by repr:
    'window' the 1 s tumbling inner join, 'inner' and 'left' the regular
    joins' materialized rows (a person with no auction at all NULL-padded)."""
    by_key = {}
    for j, (k, t) in enumerate(zip(ak, ts)):
        by_key.setdefault(int(k), []).append((j, int(t)))
    out = []
    for i, (k, t) in enumerate(zip(pk, ts)):
        matches = [j for j, ta in by_key.get(int(k), ())
                   if kind != "window" or ta // 1000 == int(t) // 1000]
        out += [{"id": int(k), "name": f"p{i}", "itemid": f"a{j}"} for j in matches]
        if kind == "left" and not matches:
            out.append({"id": int(k), "name": f"p{i}", "itemid": None})
    return sorted(map(repr, out))


def join_leg_c(sz, dev) -> dict:
    """The SQL front door: the bench's q8 statement fused (DeviceJoinRunner,
    sql_origin), with device joins off and with table.device-fusion off,
    at row parity and against a Python model; FULL OUTER refused with its
    catalogued reason; regular INNER and LEFT OUTER joins on the
    StreamingJoinRunner, their materialized changelogs against the model."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.joins.spec import JoinUnsupported
    from flink_tpu_torch.ops import join_ring
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.table.changelog import DELETE, ROW_KIND_FIELD, materialize

    out, rows = {}, {}
    for route, kw in (("fused", {}), ("device_joins_off", {"device_joins": False}),
                      ("fusion_off", {"fusion": False})):
        env, tenv, cols = join_sql_env(sz, sz["sql_rows"], dev=dev, **kw)
        report = tenv.explain_sql(SQL_Q8)
        sink = tenv.sql_query(SQL_Q8).collect()
        runners = build_runners(plan(env._sinks), env.config, dev)[0]
        join_ring.reset_call_counts()
        t0 = time.perf_counter()
        env.execute("sql-join")
        _sync(dev)
        rows[route] = sorted(map(repr, sink.results))
        out[route] = {"fused": report.fused, "reason": report.reason,
                      "explain": report.describe()[:200],
                      "runners": sorted({type(r).__name__ for r in runners}),
                      "sql_origin": any(getattr(r, "sql_origin", False) for r in runners),
                      "program_calls": dict(join_ring.CALLS),
                      "seconds": time.perf_counter() - t0, "rows": len(rows[route])}
    model = join_sql_model(*cols, "window")
    fused = out["fused"]
    out["parity"] = bool(rows["fused"] == rows["device_joins_off"] == rows["fusion_off"] == model
                         and len(model) > 0)
    ok = (out["parity"] and fused["fused"] and "device=join-ring" in fused["explain"]
          and "DeviceJoinRunner" in fused["runners"] and fused["sql_origin"]
          and fused["program_calls"]["join_match"] > 0
          and "WindowJoinRunner" in out["device_joins_off"]["runners"]
          and out["fusion_off"]["reason"] == "disabled")
    env, tenv, _cols = join_sql_env(sz, sz["sql_rows"], dev=dev)
    full = {"reason": tenv.explain_sql(SQL_FULL).reason}
    try:
        tenv.sql_query(SQL_FULL)
        full["raised"] = None
    except JoinUnsupported as e:
        full["raised"] = e.reason
    out["full_outer"] = full
    ok = ok and full["reason"] == full["raised"] == "join-full-outer"
    for kind, sql in SQL_REGULAR.items():
        env, tenv, cols = join_sql_env(sz, sz["regular_rows"], dev=dev)
        log = tenv.execute_sql_to_changelog(sql)
        kinds = sorted({type(r).__name__ for r in build_runners(
            plan(env._sinks), env.config, dev)[0]})
        got = sorted(map(repr, materialize(log)))
        leg = {"changelog_rows": len(log), "materialized": len(got),
               "retractions": sum(r.get(ROW_KIND_FIELD) == DELETE for r in log),
               "runners": kinds, "equals_model": got == join_sql_model(*cols, kind)}
        leg["ok"] = bool(leg["equals_model"] and "StreamingJoinRunner" in kinds and got
                         and (kind == "inner" or leg["retractions"] > 0))
        out[f"regular_{kind}"] = leg
        ok = ok and leg["ok"]
    out["ok"] = bool(ok)
    return out


def join_leg_d(sz, dev) -> dict:
    """Degrade in place, mid-stream: q8 zipf with 16 slots a (key, bucket)
    side degrades with join-ring-overflow; q8 with 1024 key lanes for 2048
    keys with join-key-capacity. Rows equal the host route's and the
    model's."""
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["events"], sz["keys"]
    out, ok = {}, True
    for name, skewed, conf, reason in (
            ("slots", True, {"execution.join.bucket-capacity": sz["degrade_slots"]},
             "join-ring-overflow"),
            ("keys", False, {"execution.state.key-capacity": sz["degrade_keys"]},
             "join-key-capacity")):
        model = st.join_model(n, keys, skewed, 1000, 1000, zipf_s=sz["zipf_s"])
        env, sink = join_env(n, "q8", sz, skewed=skewed, conf=conf, dev=dev)
        d = join_run(env, dev)
        envh, sinkh = join_env(n, "q8", sz, skewed=skewed, conf=conf, device_joins=False,
                               dev=dev)
        join_run(envh, dev)
        rows = st.join_row_ids(sink.results)
        r = d["runner"]
        leg = {"fallback_reason": r.fallback_reason, "degraded": r._host is not None,
               "rows": len(rows), "equals_host": bool(np.array_equal(
                   rows, st.join_row_ids(sinkh.results))),
               "equals_model": bool(np.array_equal(rows, model)),
               "program_calls": d["calls"]}
        leg["ok"] = bool(type(r).__name__ == "DeviceJoinRunner" and leg["degraded"]
                         and r.fallback_reason == reason and leg["equals_host"]
                         and leg["equals_model"] and len(rows) > 0)
        out[name] = leg
        ok = ok and leg["ok"]
    out["ok"] = bool(ok)
    return out


def join_leg_e(sz, dev, tmp: str) -> dict:
    """Exactly-once: q8 uniform (2^16 records a side) through
    env.execute_async with checkpoints every `interval` ms and one host
    failure in the sink at `fail_at` of the event time: one restart from a
    reported checkpoint, rows equal to the uninterrupted run's and the
    model's, the restarted attempt's device memory at its first sink batch
    within `mem_slack` of the first attempt's. Uniform keys: every key is
    seen before the first fire, so both attempts hold the same ring
    geometry there (a zipf run restores at its grown geometry by design)."""
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["ckpt_events"], sz["keys"]
    model = st.join_model(n, keys, False, 1000, 1000)
    env, sink = join_env(n, "q8", sz, dev=dev)
    ref = join_run(env, dev)
    rows_ref = st.join_row_ids(sink.results)
    del env, sink, ref
    fail_ts = st.API_T0_MS + int(st.API_SPAN_EVENT_MS * sz["fail_at"])
    fsink = FailOnceSink(timed_collect_sink(), fail_ts)
    env, _s = join_env(n, "q8", sz, sink=fsink, dev=dev, conf={
        "execution.checkpointing.interval": sz["interval"],
        "execution.checkpointing.dir": f"{tmp}/chk",
        "restart-strategy.type": "fixed-delay", "restart-strategy.initial-backoff": 1})
    _sync(dev)
    t0 = time.perf_counter()
    client = env.execute_async("api_join_exactly_once")
    client.wait(600)
    _sync(dev)
    secs = time.perf_counter() - t0
    got = st.join_row_ids([row for row, _t in fsink.inner.results])
    runner = next(r for r in client._runtime.runners if type(r).__name__ == "DeviceJoinRunner")
    mem = fsink.first_write_bytes
    out = {"events_per_side": n, "interval_ms": sz["interval"], "seconds": secs,
           "status": client.status().value, **ckpt_stats(client),
           "rows": len(got), "equals_uninterrupted": bool(np.array_equal(got, rows_ref)),
           "equals_model": bool(np.array_equal(got, model)),
           "device_route": runner._host is None and runner.fallback_reason is None,
           "first_write_allocated_bytes": mem,
           "memory_bounded": len(mem) == 2 and mem[1] <= mem[0] + sz["mem_slack"]}
    out["ok"] = bool(out["status"] == "FINISHED" and out["num_restarts"] == 1
                     and out["restored_checkpoint_id"] is not None
                     and out["equals_uninterrupted"] and out["equals_model"] and len(got) > 0
                     and out["device_route"] and out["memory_bounded"])
    return out


def api_join_phase(dev=DEV, sizes=None) -> dict:
    """Phase 23: legs A-E (see API_JOIN), each a failure of the phase."""
    import shutil
    import tempfile

    sz = sizes or API_JOIN
    out = {"phase": "api_join"}
    for leg, fn in (("leg_a", join_leg_a), ("leg_b", join_leg_b), ("leg_c", join_leg_c),
                    ("leg_d", join_leg_d), ("leg_e", join_leg_e)):
        t0 = time.perf_counter()
        if leg == "leg_e":
            tmp = tempfile.mkdtemp(prefix="chip_smoke_join_")
            try:
                out[leg] = fn(sz, dev, tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            out[leg] = fn(sz, dev)
        out[leg]["leg_s"] = time.perf_counter() - t0
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    out["ok"] = bool(all(out[leg]["ok"] for leg in ("leg_a", "leg_b", "leg_c", "leg_d",
                                                     "leg_e")))
    return out


def join_programs(calls_per_run: dict, dev=DEV) -> dict:
    """B5's torch programs at leg B's geometry (NB = 65, K = 2^16, C = 16):
    ms a call (CUDA events), device us a call by kernel (profiler), CUDA
    launches a call and a run (leg B's first device run's calls), and a
    bytes bound. The ingest scatters one batch (1024 records, one bucket,
    distinct keys, as the ring stages them); the matches read one bucket
    a side with a quarter of the keys holding a record (leg B's window)."""
    from flink_tpu_torch.ops import join_ring as jr
    from flink_tpu_torch.testing.timing import cuda_ms, device_profile

    NB, K, C, B = 65, API_JOIN["big_keys"], 16, API_JOIN["batch"]
    d = torch.device(dev)
    g = torch.Generator().manual_seed(5)
    arrs = [torch.randint(0, 1 << 20, (NB, K, C), generator=g, dtype=torch.int32).to(d)
            for _ in range(4)]
    lanes = [t.to(d) for t in (
        torch.full((B,), 7, dtype=torch.int32),
        torch.randperm(K, generator=g)[:B].to(torch.int32),
        torch.zeros(B, dtype=torch.int32), torch.arange(B, dtype=torch.int32),
        torch.randint(0, 1000, (B,), generator=g, dtype=torch.int32))]
    cnt = (torch.rand((1, K), generator=g) < 0.25).to(torch.int32).to(d)
    rbs = torch.tensor([7], dtype=torch.int32, device=d)
    ingest = jr.build_join_ingest(NB, K, C)
    match = jr.build_join_match(NB, K, C, 1, 1, False)
    interval = jr.build_join_match(NB, K, C, 1, 1, True)
    L = C
    # per side: the bucket run of both arrays and the counts read; both
    # lane arrays and the validity written; the pair counts written
    match_bytes = 2 * (2 * K * L * 4 + K * 4 + 2 * K * L * 4 + K * L) + K * 4
    programs = {
        # five int32 lanes read; two int32 cells written per record
        "join_ingest": ("flink_tpu/ops/join_ring.py:48",
                        lambda: ingest(arrs[0], arrs[1], *lanes), B * 5 * 4 + B * 2 * 4,
                        "join_ingest"),
        "join_match": ("flink_tpu/ops/join_ring.py:70",
                       lambda: match(arrs[0], arrs[1], cnt, rbs, arrs[2], arrs[3], cnt, rbs,
                                     0, 0), match_bytes, "join_match"),
        # plus the [K, L, R] mask written
        "join_match_interval": ("flink_tpu/ops/join_ring.py:70",
                                lambda: interval(arrs[0], arrs[1], cnt, rbs, arrs[2], arrs[3],
                                                 cnt, rbs, -500, 500),
                                match_bytes + K * L * L, "join_match_interval"),
    }
    out = {}
    for name, (replaces, fn, nbytes, calls_key) in programs.items():
        b_ms, b_by = bound(nbytes, 0)
        split, per_call = device_profile(fn)
        calls = calls_per_run.get(calls_key, 0)
        out[name] = {"replaces": replaces, "shape": f"NB={NB} K={K} C={C} B={B} nb=1",
                     "ms": cuda_ms(fn, 20), "device_us": sum(split.values()),
                     "device_us_by_kernel": split, "launches_per_call": per_call,
                     "calls_per_run": calls, "launches_per_run": per_call * calls,
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
                     "library_ms": None}
    return out


def per_batch_programs(card: str, calls_per_batch: dict, dev=DEV, join=None) -> dict:
    """Each torch program of the per-batch operators at lateness_operator's
    shapes (the global count step at api_count_window's, the group-agg step
    at api_group_agg's): ms a call (CUDA events), device us a call by kernel
    (profiler), CUDA launches a call and a batch, and a bytes bound from
    this run's data; and `join`, the join ring's programs (`join_programs`)."""
    from flink_tpu_torch.ops import segment_ops as so
    from flink_tpu_torch.ops.aggregators import sum_agg
    from flink_tpu_torch.ops.sorted_ingest import sorted_ingest
    from flink_tpu_torch.runtime import group_agg_operator as ga
    from flink_tpu_torch.runtime import tpu_global_window_operator as gw
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_profile

    z = LATENESS
    K, B = z["K"], z["B"]
    op = lateness_op(dev, z)
    S, spw = op.S, op.spw
    agg = sum_agg()
    acc, cnt = so.init_state_arrays(agg, K, S, torch.device(dev))
    keys, ts, vals = st.late_records(np.arange(B, 2 * B, dtype=np.int64), B, K)
    lanes = so.stage_lanes(keys.astype(np.int32), ((ts // st.SLIDE_MS) % S).astype(np.int32),
                           vals, K, S, torch.device(dev))
    so.ingest(agg, acc, cnt, lanes)
    cells = int(torch.unique(lanes.cells(K)).numel())
    rings = 2                                             # count and sum, 4 B each
    # the window ending at the batch's newest slice; the purge takes the
    # row before it
    last = int(((ts // st.SLIDE_MS) % S).max())
    window = [(last - spw + 1 + i) % S for i in range(spw)]
    stale = (last - spw) % S
    programs = {
        # lanes read once (kid, spos, value); each touched cell of both rings
        # read and written once
        "ingest_scatter": ("flink_tpu/ops/segment_ops.py:60",
                           lambda: so.ingest(agg, acc, cnt, lanes),
                           B * 12 + cells * rings * 4 * 2, B * rings, "ingest"),
        "ingest_sort": ("flink_tpu/ops/sorted_ingest.py:54",
                        lambda: sorted_ingest(agg, acc, cnt, lanes),
                        B * 12 + cells * rings * 4 * 2, B * rings, "ingest_sort"),
        # the window's rows of both rings read; result, count and mask written
        "fire": ("flink_tpu/ops/segment_ops.py:97",
                 lambda: so.fire(agg, acc, cnt, window),
                 spw * K * rings * 4 + K * (4 + 4 + 1), spw * K * rings, "fire"),
        "fire_masked": ("flink_tpu/ops/segment_ops.py:97",
                        lambda: so.fire(agg, acc, cnt, window, lanes),
                        spw * K * rings * 4 + K * (4 + 4 + 1) + B * 8, spw * K * rings + B,
                        "fire_masked"),
        # one row of both rings written
        "purge": ("flink_tpu/ops/segment_ops.py:132",
                  lambda: so.purge(agg, acc, cnt, [stale]), K * rings * 4, 0, "purge"),
    }
    # the global count step at api_count_window's shapes: one batch's lanes
    zc = API_COUNT
    col, _t = count_columns(np.arange(zc["batch"], dtype=np.int64), zc)
    gk = torch.from_numpy(col[:, 0].astype(np.int32)).to(dev)
    gv = torch.from_numpy(col[:, 1]).to(dev)
    gacc = {"sum": torch.zeros(zc["keys"], device=dev)}
    gcnt = torch.zeros(zc["keys"], dtype=torch.int32, device=dev)
    gfired = torch.zeros(zc["keys"], dtype=torch.int32, device=dev)
    gkeys = int(torch.unique(gk).numel())
    programs["global_count_step"] = (
        "flink_tpu/runtime/tpu_global_window_operator.py:35",
        lambda: gw.step(agg, gacc, gcnt, gfired, gk, gv, zc["n"], True),
        # lanes read; touched keys' acc and count read and written; the
        # extract and the mask over K written, acc and count over K rewritten
        zc["batch"] * 8 + gkeys * 2 * 4 * 2 + zc["keys"] * (4 + 1 + 2 * 4), zc["batch"] * 2,
        "global_count_step")
    # the group-agg step at api_group_agg's shapes: a batch of 65536 rows
    # over 2^16 keys, three linear columns
    zg = API_GROUP_AGG
    rng = np.random.default_rng(0)
    L, b, cap = 3, zg["batch"], 2 * zg["keys"]
    slots = torch.from_numpy(rng.integers(0, zg["keys"], b).astype(np.int32)).to(dev)
    signs = torch.from_numpy(np.where(rng.random(b) < zg["retract"], -1, 1).astype(np.int32)).to(dev)
    gvals = torch.from_numpy(rng.integers(0, 100, (L, b)).astype(np.float32)).to(dev)
    nn = torch.ones((L, b), dtype=torch.int32, device=dev)
    uniq = torch.unique(slots).long()
    u = int(uniq.numel())
    gcols = (torch.zeros(cap, dtype=torch.int32, device=dev),
             torch.zeros((L, cap), device=dev), torch.zeros((L, cap), dtype=torch.int32, device=dev))
    programs["group_agg_step"] = (
        "flink_tpu/runtime/group_agg_operator.py:100",
        lambda: ga.device_step(*gcols, slots, signs, gvals, nn, uniq),
        # rows read (slot, sign, L values, L non-null counts); the distinct
        # keys' columns read before and after, and read and written by the
        # scatter
        b * (8 + 8 * L) + u * (4 + 8 * L) * 4, b * (1 + 2 * L), "group_agg_step")
    out = {"phase": "per_batch_programs", "card": card,
           "shape": f"K={K} S={S} B={B} spw={spw} (sum); global step K={zc['keys']} "
                    f"B={zc['batch']}; group-agg cap={cap} B={b} L={L}",
           "cells_touched": cells}
    for name, (replaces, fn, nbytes, nops, calls_key) in programs.items():
        b_ms, b_by = bound(nbytes, nops)
        split, per_call = device_profile(fn)
        out[name] = {"replaces": replaces, "ms": cuda_ms(fn, 5), "device_us": sum(split.values()),
                     "device_us_by_kernel": split, "launches_per_call": per_call,
                     "calls_per_batch": calls_per_batch.get(calls_key, 1.0),
                     "launches_per_batch": per_call * calls_per_batch.get(calls_key, 1.0),
                     "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes}
    # the host side of a fire: nonzero of the mask (a sync) and the copy of
    # the fired keys and values, the operator's _emit_window on a full ring
    op.state.acc, op.state.count = acc, cnt
    reps = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        op._emit_window(window[0] // op.sl, touch_mask=False)
        _sync(dev)
        reps.append((time.perf_counter() - t0) * 1e3)
        emitted = op.drain_output()
    out["emit_window_host_ms"] = float(np.median(reps))
    out["emit_window_keys"] = int(len(emitted[0][2][0])) if emitted else 0
    out.update(join or {})
    return out


# ---------------------------------------------------------------------------
# phase 24, api_mesh: the mesh (parallel/) on four virtual shards of the one
# card. Four shards time-share one card, so a mesh-to-card tuples/s ratio
# measures the mesh's overhead, not scaling.
# ---------------------------------------------------------------------------

API_MESH = dict(keys=8192, batch=8192, shards=4, zipf_s=1.0, parity_events=1 << 17,
                timed_events=1 << 20, runs=2, big_keys=1 << 20, big_events=1 << 21,
                op_keys=1 << 20, op_events=1 << 21, op_batch=1 << 16, op_window=10_000)


def _shard_device(dev) -> torch.device:
    d = torch.device(dev)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def mesh_shards(n: int, dev) -> None:
    """Let the port see n shards of `dev` (parallel/mesh.py's
    visible_devices, which the tests replace the same way): four shards of
    the one card, or of the CPU in a rehearsal."""
    from flink_tpu_torch.parallel import mesh as mesh_lib

    d = _shard_device(dev)
    mesh_lib.visible_devices = lambda device: [d] * n


def mesh_columns(idx: np.ndarray, n: int, sz, skewed: bool, perm=None):
    """`bench.py::multichip_microbench`'s columns: (campaign, event_type)
    with campaigns uniform (idx * 2654435761) % K or zipf(s) through
    zipf_keys with the hot ranks placed by `perm` (a default_rng(11)
    permutation unless given); 64 s of event time over the n records."""
    from flink_tpu_torch.testing import stream as st

    K = sz["keys"]
    if skewed:
        perm = np.random.default_rng(11).permutation(K) if perm is None else perm
        camp = perm[st.zipf_keys(idx, K, sz["zipf_s"])]
    else:
        camp = (idx * 2654435761) % K
    col = np.stack([camp, idx % 3], axis=1).astype(np.float32)
    return col, (10_000 + idx * 64_000 // n).astype(np.int64)


def mesh_job(n: int, sz, *, skewed=False, shards=0, combine=False, columnar=False, dev=DEV,
             perm=None, filt=_t_filter, conf=None, hook=None, sink=None):
    """(env, sink) of multichip_microbench's program: a traceable filter
    (`filt`, one record in three by default), a traceable key, 10 s windows
    sliding by 1 s, count; `shards` > 0 runs it with parallel.mesh.enabled
    over that many shards (local-combine with `combine`). `perm`: the zipf
    placement (mesh_columns'); `conf`: further options; hook(idx) runs
    before each source batch (gates); `sink`: rows_sink() unless given."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    opts = {"execution.step.batch-size": sz["batch"],
            "execution.state.key-capacity": sz["keys"],
            "execution.window.columnar-output": columnar,
            "parallel.mesh.enabled": shards > 0}
    if shards:
        opts.update({"parallel.mesh.devices": shards, "parallel.mesh.local-combine": combine})
    opts.update(conf or {})
    env = StreamExecutionEnvironment(Configuration(opts), device=dev)
    sink = rows_sink() if sink is None else sink

    def gen(idx):
        if hook is not None:
            hook(idx)
        return Batch(*mesh_columns(idx, n, sz, skewed, perm))

    (env.from_source(DataGeneratorSource(gen, n), WatermarkStrategy.for_bounded_out_of_orderness(0))
        .filter(filt, traceable=True).key_by(_t_key, traceable=True)
        .window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
        .aggregate("count").sink_to(sink))
    return env, sink


def mesh_run(env, dev=DEV) -> dict:
    """One execute() with the launch counts at 0 just before it: seconds
    and K1's launches (lane entry and partials entry)."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    return {"seconds": time.perf_counter() - t0, "k1": cs.LAUNCHES["k1_superscan"],
            "k1_partials": cs.LAUNCHES["k1_partials"]}


def mesh_model(n: int, sz, skewed: bool, perm=None, filt=_t_filter) -> dict:
    """numpy: {window index: counts over the keys} of mesh_columns' stream
    (zipf placement `perm`) through the job's filter `filt`."""
    col, ts = mesh_columns(np.arange(n, dtype=np.int64), n, sz, skewed, perm)
    keep = np.asarray(filt(col))
    keys, ts = col[keep, 0].astype(np.int64), ts[keep]
    spw = API["window"] // API["slide"]
    newest = ts // API["slide"]
    fired = {}
    for w in range(spw):
        j = newest - w
        for jj in np.unique(j):
            row = fired.setdefault(int(jj), np.zeros(sz["keys"]))
            np.add.at(row, keys[j == jj], 1)
    return fired


def _fired_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[j], b[j]) for j in a)


def mesh_leg_a(sz, dev) -> dict:
    """Row-mode parity at parity_events, uniform and zipf: the mesh job, the
    mesh job with local-combine, the one-card job and the numpy model; the
    runner selection; K1's launches; tuples/s at timed_events, best of
    `runs`, interleaved (card, mesh, mesh, card)."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    n_sh = sz["shards"]
    env, _sink = mesh_job(1 << 14, sz, shards=n_sh, dev=dev)
    runners, _feeds = build_runners(plan(env._sinks), env.config, dev)
    chain = [r for r in runners if type(r).__name__ == "DeviceChainRunner"]
    out = {"fused_selected": bool(chain),
           "sharded_selected": bool(chain) and chain[0].op.mesh_devices() == n_sh,
           "pipeline": type(chain[0].op.pipe).__name__ if chain else None}
    del env, runners, chain
    ok = out["fused_selected"] and out["sharded_selected"]
    n = sz["parity_events"]
    for label, skewed in (("uniform", False), ("zipf", True)):
        model = mesh_model(n, sz, skewed)
        leg = {}
        for name, shards, combine in (("mesh", n_sh, False), ("mesh_combine", n_sh, True),
                                      ("card", 0, False)):
            env, sink = mesh_job(n, sz, skewed=skewed, shards=shards, combine=combine, dev=dev)
            r = mesh_run(env, dev)
            r["equals_model"] = _fired_equal(api_fired(sink, API["window"], API["slide"]),
                                             model)
            leg[name] = r
        card_k1 = leg["card"]["k1"]
        leg["k1_per_dispatch_ratio"] = leg["mesh"]["k1"] / max(card_k1, 1)
        leg["k1_partials_per_dispatch_ratio"] = leg["mesh_combine"]["k1_partials"] / max(card_k1, 1)
        leg["windows"] = len(model)
        leg["ok"] = bool(all(leg[k]["equals_model"] for k in ("mesh", "mesh_combine", "card"))
                         and card_k1 > 0 and leg["mesh"]["k1"] == n_sh * card_k1
                         and leg["mesh_combine"]["k1_partials"] == n_sh * card_k1
                         and leg["mesh_combine"]["k1"] == 0)
        ok = ok and leg["ok"]
        out[label] = leg
    # timed, columnar: card, mesh, mesh, card (best of runs each)
    nt = sz["timed_events"]
    mesh_run(mesh_job(1 << 16, sz, shards=n_sh, columnar=True, dev=dev)[0], dev)  # warm-up
    times = {"card": [], "mesh": []}
    order = ["card", "mesh", "mesh", "card"] * max(1, sz["runs"] // 2)
    for name in order:
        r = mesh_run(mesh_job(nt, sz, shards=n_sh if name == "mesh" else 0, columnar=True,
                              dev=dev)[0], dev)
        times[name].append(r)
    for name, runs in times.items():
        secs = min(r["seconds"] for r in runs)
        out[f"{name}_tuples_per_s"] = nt / secs
        out[f"{name}_timed"] = {"events": nt, "seconds": [r["seconds"] for r in runs],
                                "k1_launches": runs[0]["k1"]}
    out["mesh_over_card"] = out["mesh_tuples_per_s"] / out["card_tuples_per_s"]
    out["note"] = ("four shards time-share one card: mesh_over_card measures the "
                   "mesh's overhead, not scaling")
    out["ok"] = bool(ok and times["mesh"][0]["k1"] > 0)
    return out


def mesh_leg_b(sz, dev, tmp: str) -> dict:
    """api_checkpoint leg B's program at deployment size (2^20 keys, a
    float32 sum, rings [32, 2^20] x 2), columnar: the one-card job and the
    4-shard job, without and with the map-side combiner (its partials cross
    in step groups), against the oracle with their device memory; a live
    rescale_mesh(2) mid-stream through execute_async; a savepoint at half
    of a 4-shard run restored on one card and on a 2-shard mesh."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.minicluster import MiniCluster
    from flink_tpu_torch.testing import stream as st

    szc = dict(API_CHECKPOINT, batch=sz.get("big_batch", API_CHECKPOINT["batch"]))
    n, keys, B = sz["big_events"], sz["big_keys"], szc["batch"]
    ref = st.api_replay(n, B, agg="sum", num_keys=keys)
    cuda = torch.device(dev).type == "cuda"
    mesh4 = {"parallel.mesh.enabled": True, "parallel.mesh.devices": sz["shards"]}
    out, ok = {"events": n, "keys": keys, "batch": B}, True

    def job(conf, hook=None):
        sink = timed_collect_sink()
        return ckpt_job(n, sink, szc, keys=keys, agg="sum", columnar=True, hook=hook,
                        conf=conf, dev=dev), sink

    from flink_tpu_torch.ops import cuda_superscan as cs

    combine = dict(mesh4, **{"parallel.mesh.local-combine": True})
    for name, conf in (("card", {}), ("mesh", mesh4), ("mesh_combine", combine)):
        env, sink = job(conf)
        before = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        run = ckpt_run(env, dev)
        fired, twice = columnar_fired(sink.results, keys)
        par, checked = st.parity(ref.fired, fired)
        rt = run["client"]._runtime
        # the combiner's dispatches run in step groups under K1's partials
        # budget: one partials launch per shard a group
        launches = cs.LAUNCHES["k1_partials"] if name == "mesh_combine" else run["k1_launches"]
        out[name] = {"seconds": run["seconds"], "k1_launches": launches,
                     "mesh_devices": rt.mesh_devices(), "parity_vs_oracle": par,
                     "windows_checked": checked, "no_window_twice": not twice,
                     "peak_allocated_delta": (torch.cuda.max_memory_allocated() - before
                                              if cuda else 0)}
        ok = ok and par and not twice and launches > 0
        del env, sink, run, rt
    out["ring_bytes"] = 2 * 32 * keys * 4
    ok = ok and out["card"]["mesh_devices"] == 1 and all(
        out[name]["mesh_devices"] == sz["shards"] for name in ("mesh", "mesh_combine"))
    # a live rescale 4 -> 2 at half of the input
    half = (n // 2 // B) * B
    gate = SourceGate(half)
    env, sink = job(mesh4, gate)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    client = env.execute_async("mesh-rescale")
    gate.reached.wait(600)
    client.rescale_mesh(2)
    gate.go.set()
    client.wait(900)
    _sync(dev)
    fired, twice = columnar_fired(sink.results, keys)
    par, checked = st.parity(ref.fired, fired)
    out["rescale"] = {"seconds": time.perf_counter() - t0, "status": client.status().value,
                      "mesh_rescales": client.mesh_rescales,
                      "num_restarts": client.num_restarts,
                      "mesh_devices_after": client._runtime.mesh_devices(),
                      "rescale_ms": client.last_mesh_rescale_duration_ms,
                      "k1_launches": cs.LAUNCHES["k1_superscan"],
                      "parity_vs_oracle": par, "no_window_twice": not twice}
    r = out["rescale"]
    ok = ok and (r["status"] == "FINISHED" and r["mesh_rescales"] == 1
                 and r["num_restarts"] == 0 and r["mesh_devices_after"] == 2 and par
                 and not twice and r["k1_launches"] > 0)
    del env, sink, client
    # a savepoint at half of a 4-shard run, restored on one card and on 2 shards
    gate = SourceGate(half, hold_at=half + 2 * B)
    env1, sink1 = job(mesh4, gate)
    sp_path = f"{tmp}/mesh_savepoint"
    out["savepoint_first_job"] = gate.savepoint(env1.execute_async("mesh-savepoint"),
                                                sp_path)["first_job"]
    del env1, sink1
    for name, conf in (("restored_card", {}),
                       ("restored_mesh2", {"parallel.mesh.enabled": True,
                                           "parallel.mesh.devices": 2})):
        env2, sink2 = job(conf)
        _sync(dev)
        cs.reset_launch_counts()
        client2 = MiniCluster.get_shared().submit(plan(env2._sinks), env2.config, name,
                                                  savepoint_restore_path=sp_path, device=dev)
        status = client2.wait(900).value
        _sync(dev)
        fired, twice = columnar_fired(sink2.results, keys)
        par, checked = st.parity(ref.fired, fired)
        out[name] = {"status": status, "mesh_devices": client2._runtime.mesh_devices(),
                     "records_in_complete": client2.records_in == n,
                     "parity_vs_oracle": par, "windows_checked": checked,
                     "no_window_twice": not twice, "k1_launches": cs.LAUNCHES["k1_superscan"]}
        ok = ok and (status == "FINISHED" and par and not twice
                     and out[name]["records_in_complete"] and out[name]["k1_launches"] > 0)
        del env2, sink2, client2
    ok = ok and out["restored_card"]["mesh_devices"] == 1 \
        and out["restored_mesh2"]["mesh_devices"] == 2
    out["ok"] = bool(ok and out["savepoint_first_job"] == "CANCELED")
    return out


def mesh_op_rows(op, keys_of) -> dict:
    """{window start: (keys, values) sorted by key} of a columnar window
    operator's output; keys_of(ids, shard) maps dense ids to keys."""
    rows = {}
    for _k, window, payload, _ts in op.drain_output():
        if isinstance(payload[0], np.ndarray) and payload[0].dtype == bool:
            mask, res = payload                      # the sharded operator's [n, K]
            parts = [(keys_of(np.flatnonzero(mask[d]), d), res[d][mask[d]])
                     for d in range(mask.shape[0])]
            ks = np.concatenate([p[0] for p in parts])
            vs = np.concatenate([p[1] for p in parts])
        else:
            ids, vs = payload
            ks = keys_of(np.asarray(ids), None)
        order = np.argsort(ks, kind="stable")
        rows[int(window.start)] = (ks[order], np.asarray(vs)[order])
    return rows


def mesh_leg_c(sz, dev) -> dict:
    """ShardedTpuWindowOperator on 2^20 keys against TpuWindowOperator
    (columnar, 10 s tumbling sums), and NEXMark q8 at api_join leg A's
    defaults with parallel.mesh.enabled: the DeviceJoinRunner's rings split
    over the shards, rows equal to the one-ring job's."""
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_window import ShardedTpuWindowOperator
    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator
    from flink_tpu_torch.testing import stream as st

    n, K, B = sz["op_events"], sz["op_keys"], sz["op_batch"]
    window = TumblingEventTimeWindows.of(sz["op_window"])
    mesh = Mesh([_shard_device(dev)] * sz["shards"])
    ops = {"sharded": ShardedTpuWindowOperator(window, "sum", mesh, key_capacity=1 << 16,
                                               num_slices=64, columnar_output=True),
           "single": TpuWindowOperator(window, "sum", key_capacity=1 << 16, num_slices=64,
                                       columnar_output=True, device=dev)}
    secs = {}
    for name, op in ops.items():
        _sync(dev)
        t0 = time.perf_counter()
        for lo in range(0, n, B):
            idx = np.arange(lo, min(n, lo + B), dtype=np.int64)
            keys = (idx * 2654435761) % K
            op.process_batch(keys, ((idx * 7) % 11).astype(np.float32),
                             10_000 + idx * 64_000 // n)
            op.process_watermark(int(10_000 + idx[-1] * 64_000 // n) - 1)
        op.process_watermark(1 << 40)
        _sync(dev)
        secs[name] = time.perf_counter() - t0
    sh, single = ops["sharded"], ops["single"]
    shard_keys = [np.asarray(d._keys) for d in sh.state.keydicts]
    single_keys = np.asarray(single.state.keydict._keys)
    got = mesh_op_rows(sh, lambda ids, d: shard_keys[d][ids])
    want = mesh_op_rows(single, lambda ids, _d: single_keys[ids])
    equal = set(got) == set(want) and all(
        np.array_equal(got[w][0], want[w][0]) and np.array_equal(got[w][1], want[w][1])
        for w in want)
    out = {"operator": {"events": n, "keys": K, "windows": len(want),
                        "rows": int(sum(len(v[0]) for v in want.values())),
                        "equal": bool(equal), "sharded_s": secs["sharded"],
                        "single_s": secs["single"],
                        "keys_per_shard": [len(d) for d in sh.state.keydicts],
                        "ring_K_per_shard": int(sh.state.K)}}
    del ops, sh, single, got, want
    # q8 at leg A's defaults, uniform, on the mesh and on one ring
    zj = API_JOIN
    env, sink = join_env(zj["events"], "q8", zj, dev=dev,
                         conf={"parallel.mesh.enabled": True,
                               "parallel.mesh.devices": sz["shards"]})
    d = join_run(env, dev)
    envs, sinks = join_env(zj["events"], "q8", zj, dev=dev)
    s1 = join_run(envs, dev)
    r = d["runner"]
    rows, rows_1 = st.join_row_ids(sink.results), st.join_row_ids(sinks.results)
    out["q8"] = {"events_per_side": zj["events"], "rows": len(rows),
                 "sharded": bool(getattr(r, "sharded", False)),
                 "num_shards": getattr(r.pipeline, "num_shards", 1),
                 "rings_on": str(r.pipeline.left.idx_arrs[0].device)
                 if getattr(r, "sharded", False) else None,
                 "equals_one_ring": bool(np.array_equal(rows, rows_1)),
                 "program_calls": d["calls"], "mesh_s": d["seconds"], "one_ring_s": s1["seconds"]}
    q = out["q8"]
    out["ok"] = bool(equal and q["sharded"] and q["num_shards"] == sz["shards"]
                     and q["equals_one_ring"] and q["rows"] > 0
                     and d["calls"]["join_match"] > 0)
    return out


def mesh_k1_inputs(sz, combine: bool, dev=DEV):
    """Shard 0's K1 inputs of leg A's first full mesh dispatch (32 steps of
    `batch` records of the timed stream) after the exchange, made by the
    sharded pipeline's own staging, prologue and routing at the operator's
    geometry: (shim with shard 0's geometry, agg, plan, inputs), the inputs
    (idx, vals) or, with `combine`, (count partial, field partials)."""
    import types

    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline
    from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue

    T, B, n = 32, sz["batch"], sz["timed_events"]
    agg = resolve("count")
    pipe = ShardedFusedPipeline(
        Mesh([_shard_device(dev)] * sz["shards"]),
        SlidingEventTimeWindows.of(API["window"], API["slide"]), agg,
        key_capacity=sz["keys"], nsb=4, fires_per_step=4, out_rows=256, chunk=4096,
        prologue=TracedPrologue((("filter", _t_filter),), _t_key), local_combine=combine)
    steps, wms = [], []
    for t in range(T):
        col, ts = mesh_columns(np.arange(t * B, (t + 1) * B, dtype=np.int64), n, sz, False)
        steps.append((col, ts))
        wms.append(int(ts.max()) - 1)
    staged = pipe.stage_superbatch_raw(steps, wms)
    plan = staged[3]
    src_idx, src_vals, _kb = pipe.source_lanes(staged, T)
    shim = types.SimpleNamespace(S=pipe.S, K=pipe.K_local, R=pipe.R, NSB=pipe.NSB, F=pipe.F,
                                 slot_spws=pipe.slot_spws)
    if combine:
        cpart, parts = pipe.route_partials(src_idx, src_vals, 0, T)[0]
        return shim, agg, plan, (cpart, parts)
    idx, vals = pipe.route_lanes(src_idx, src_vals)[0]
    return shim, agg, plan, (idx.reshape(-1), vals)


def k1_partials_at(label: str, shim, agg, plan, cpart, parts) -> dict:
    """K1's partials entry against its plain version on one shard's
    dispatch (bit-equal), with its time, the plain version's, one
    index_add_ of the count partial into its ring cells as the library
    yardstick, its bound and its device time by kernel."""
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops.superscan import keyed_superscan_partials_plain
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    S_, K_, T_ = shim.S, shim.K, int(plan[0].shape[0])
    kw = dict(NSB=shim.NSB, R=shim.R, spws=shim.slot_spws())
    kc, ks = _fresh_rings(agg, (S_, K_), DEV, False)
    pc, ps = _fresh_rings(agg, (S_, K_), DEV, False)
    kph, pph = _phase(), _phase()
    ko = cs.keyed_superscan_partials(agg, kc, ks, cpart, parts, plan[:5], phase=kph, **kw)
    po = keyed_superscan_partials_plain(agg, pc, ps, cpart, parts, plan[:5], phase=pph, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in ([(kc, pc), (ko[0], po[0]), (kph, pph)] + list(zip(ks, ps))
                 + list(zip(ko[1], po[1]))):
        err = max(err, _max_abs_err(a, b))
        if not torch.equal(a, b):
            raise AssertionError(f"k1_partials differs from its plain version: {err}")
    timed = on_off_ms(lambda ph: cs.keyed_superscan_partials(agg, kc, ks, cpart, parts,
                                                             plan[:5], phase=ph, **kw))
    plain_ms = cuda_ms(lambda: keyed_superscan_partials_plain(agg, pc, ps, cpart, parts,
                                                              plan[:5], phase=_phase(), **kw),
                       2, 3)
    NSB = shim.NSB
    t = torch.arange(T_, device=cpart.device)[:, None, None]
    k = torch.arange(K_, device=cpart.device)[None, :, None]
    r = torch.arange(NSB, device=cpart.device)[None, None, :]
    cells = (((plan[0].long()[t] + r) % S_) * K_ + k).reshape(-1)
    flat, src = kc.view(-1), cpart.reshape(-1)
    lib_ms = cuda_ms(lambda: flat.index_add_(0, cells, src), 10)
    cost = cs.k1_partials_cost(T=T_, K=K_, S=S_, NSB=NSB, F=shim.F, nf=len(ks),
                               fires=len(plan[5]))
    b_ms, b_by = bound(cost["bytes_accessed"], cost["flops"])
    return {"shape": f"{label}, T={T_} K_local={K_} NSB={NSB} S={S_} R={shim.R} F={shim.F}",
            **timed, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "fires": len(plan[5]),
            "phase_counts": kph.tolist(),
            "device_us": device_split_us(lambda: cs.keyed_superscan_partials(
                agg, kc, ks, cpart, parts, plan[:5], phase=_phase(), **kw))}


def mesh_programs(card: str, dev=DEV) -> dict:
    """The mesh's torch programs (XLA programs in the JAX package, no
    Pallas form) at leg A's dispatch shapes, each with its time (CUDA
    events), device time by kernel and bound: B8 the keyBy exchange of a
    dispatch's lanes (4 source shards of [32, 2048]) and of its partials,
    B4 one source shard's segment partials, B7 count_hist and
    weighted_hist over the same lanes."""
    from flink_tpu_torch.ops import matmul_hist
    from flink_tpu_torch.ops.superscan import segment_partials
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

    sz = API_MESH
    n_sh, T, Bs = sz["shards"], 32, sz["batch"] // sz["shards"]
    out = {"phase": "mesh_programs", "card": card}
    for agg_name in ("count", "sum"):
        pipe = ShardedFusedPipeline(Mesh([_shard_device(dev)] * n_sh),
                                    SlidingEventTimeWindows.of(API["window"], API["slide"]),
                                    agg_name, key_capacity=sz["keys"], nsb=4, fires_per_step=4,
                                    out_rows=256, chunk=4096)
        rng = np.random.default_rng(5)
        src_idx = [torch.tensor(np.where(rng.random((T, Bs)) < 1 / 3,
                                         rng.integers(0, sz["keys"] * 4, (T, Bs)), -1),
                                dtype=torch.int32, device=dev) for _ in range(n_sh)]
        src_vals = ([torch.tensor(rng.integers(0, 11, (T, Bs)), dtype=torch.float32,
                                  device=dev) for _ in range(n_sh)]
                    if agg_name == "sum" else [None] * n_sh)
        live = int(sum(int((i >= 0).sum()) for i in src_idx))
        nv = 0 if agg_name == "count" else 1
        lanes = n_sh * T * Bs
        # B8, lanes: each source reads its lanes once and writes n masked
        # blocks; each destination receives n * B_s lanes a step
        b = bound(lanes * 4 * (1 + nv) * (1 + n_sh) + lanes * 4 * (1 + nv) * n_sh, lanes * n_sh)
        f = lambda: pipe.route_lanes(src_idx, src_vals)  # noqa: E731
        out[f"b8_exchange_lanes_{agg_name}"] = {
            "shape": f"{n_sh} sources x [T={T}, B_s={Bs}] lanes, {live} live",
            "ms": cuda_ms(f, 10), "device_us": device_split_us(f),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        nseg = n_sh * pipe.K_local * 4
        part_bytes = T * nseg * 4 * (1 + nv)
        b = bound(lanes * 4 * (1 + nv) + n_sh * part_bytes * 2, live * (1 + nv) + n_sh * T * nseg)
        f = lambda: pipe.route_partials(src_idx, src_vals, 0, T)  # noqa: E731
        out[f"b8_exchange_partials_{agg_name}"] = {
            "shape": f"{n_sh} sources x [T={T}] partials of {nseg} segments (B4 inside)",
            "ms": cuda_ms(f, 10), "device_us": device_split_us(f),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
        agg = resolve(agg_name)
        i0, v0 = src_idx[0], src_vals[0]
        b = bound(T * Bs * 4 * (1 + nv) + part_bytes, int((i0 >= 0).sum()) * (1 + nv))
        f = lambda: segment_partials(agg, i0, v0, nseg)  # noqa: E731
        out[f"b4_segment_partials_{agg_name}"] = {
            "shape": f"one source: [T={T}, B_s={Bs}] lanes into T x {nseg} segments",
            "ms": cuda_ms(f, 10), "device_us": device_split_us(f),
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    flat = src_idx[0].reshape(-1)
    fv = torch.ones(flat.numel(), dtype=torch.float32, device=dev)
    b = bound(flat.numel() * 4 + nseg * 4, int((flat >= 0).sum()))
    f = lambda: matmul_hist.count_hist(flat, nseg)  # noqa: E731
    out["b7_count_hist"] = {"shape": f"{flat.numel()} ids into {nseg} segments",
                            "ms": cuda_ms(f, 10), "device_us": device_split_us(f),
                            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    b = bound(flat.numel() * 8 + nseg * 4, int((flat >= 0).sum()))
    f = lambda: matmul_hist.weighted_hist(flat, fv, nseg)  # noqa: E731
    out["b7_weighted_hist"] = {"shape": f"{flat.numel()} ids and values into {nseg} segments",
                               "ms": cuda_ms(f, 10), "device_us": device_split_us(f),
                               "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    return out


def api_mesh_phase(dev=DEV, sizes=None) -> dict:
    """Legs A, B and C over four shards of `dev` (visible_devices replaced
    for the phase, restored after)."""
    import tempfile

    from flink_tpu_torch.parallel import mesh as mesh_lib

    sz = dict(API_MESH, **(sizes or {}))
    real = mesh_lib.visible_devices
    mesh_shards(sz["shards"], dev)
    out = {"phase": "api_mesh", "shards": sz["shards"], "shard_devices":
           [str(d) for d in mesh_lib.visible_devices(dev)]}
    try:
        t0 = time.perf_counter()
        out["leg_a"] = mesh_leg_a(sz, dev)
        out["leg_a"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="api_mesh_") as tmp:
            out["leg_b"] = mesh_leg_b(sz, dev, tmp)
        out["leg_b"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["leg_c"] = mesh_leg_c(sz, dev)
        out["leg_c"]["phase_s"] = time.perf_counter() - t0
    finally:
        mesh_lib.visible_devices = real
    out["ok"] = bool(out["leg_a"]["ok"] and out["leg_b"]["ok"] and out["leg_c"]["ok"])
    return out


# ---------------------------------------------------------------------------
# phase 25: api_metrics, job metrics, latency markers, emission latency,
# traces, history and the doctor (flink_tpu_torch/metrics/) on the fused
# K1 job and the other runner families
# ---------------------------------------------------------------------------

API_METRICS = dict(keys=8192, batch=65536, events=1 << 22, warmup_events=1 << 18,
                   checkpoint_ms=100, marker_ms=5, history_ms=50,
                   lateness_events=1 << 20, session_events=1 << 20,
                   latency_events=1 << 20, tiered_events=1 << 16, tiered_keys=1 << 15,
                   tiered_hot=4096)
# the options that turn every plane of the metrics off (there is no switch
# for the history: a sampling interval past the run leaves its first tick)
METRICS_OFF = {"observability.emission-latency.enabled": False,
               "observability.device-timing.enabled": False,
               "observability.device.enabled": False,
               "observability.latency-markers.interval-ms": -1,
               "observability.doctor.enabled": False,
               "observability.history.interval-ms": 3_600_000}
# the keys of the JAX package's JobClient reports (flink_tpu/runtime/
# minicluster.py latency_report, history_report, doctor_report)
REPORT_KEYS = {
    "latency_report": ["attribution", "emission", "latency_mode", "operators", "p50_ms",
                       "p999_ms", "p99_ms", "samples", "watermarkLagMs"],
    "history_report": ["enabled", "interval_ms", "retention_points", "sample_count",
                       "sample_time_ms", "series"],
    "doctor_report": ["diagnoses", "samples", "score", "verdict", "watchdog_events",
                      "window_ms"],
}


class _CallCounts:
    """Counts calls of the named methods of `cls` while active (the
    methods are wrapped at class level and restored on exit)."""

    def __init__(self, cls, names):
        self.cls, self.names = cls, names
        self.counts = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.cls, n) for n in self.names}
        for n, f in self.saved.items():
            def wrap(*a, _f=f, _n=n, **kw):
                self.counts[_n] += 1
                return _f(*a, **kw)
            setattr(self.cls, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.cls, n, f)
        return False


def metrics_snapshot_of(registry) -> dict:
    from flink_tpu_torch.metrics.registry import metrics_snapshot

    return metrics_snapshot(registry.all_metrics())


def _operator(snap: dict, uid_prefix: str) -> str:
    return next(k.split(".")[2] for k in snap
                if k.startswith(f"job.operator.{uid_prefix}"))


def metrics_job(n: int, sink, sz, *, conf=None, checkpoint_ms=0, dev=DEV):
    """env of the api_ysb fused program (columnar) over n records, leg A's
    observability options and checkpoints every checkpoint_ms (0: off), in
    memory; `conf` adds or overrides options."""
    opts = {"observability.latency-markers.interval-ms": sz["marker_ms"],
            "observability.emission-latency.enabled": True,
            "observability.doctor.enabled": True,
            "observability.history.interval-ms": sz["history_ms"]}
    opts.update(conf or {})
    return ckpt_job(n, sink, sz, interval=checkpoint_ms, columnar=True, conf=opts, dev=dev)


def metrics_leg_a(sz, dev) -> dict:
    """The metrics job through execute_async: its rows against the same job
    with every plane off and the numpy model, and its metrics, spans and
    reports against what the run did."""
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["events"], sz["keys"]
    ckpt_run(metrics_job(sz["warmup_events"], timed_collect_sink(), sz, dev=dev), dev)
    off_sink = timed_collect_sink()
    off = ckpt_run(metrics_job(n, off_sink, sz, conf=METRICS_OFF, dev=dev), dev)
    sink = timed_collect_sink()
    # the sections the fused chain's runner times (a non-empty batch, a
    # watermark, a drain) and the fires its operator resolves
    with _CallCounts(FusedWindowOperator, ("process_raw_batch", "process_watermark",
                                           "drain_output", "_emit")) as calls:
        on = ckpt_run(metrics_job(n, sink, sz, checkpoint_ms=sz["checkpoint_ms"], dev=dev), dev)
    client = on["client"]
    snap = metrics_snapshot_of(client.metrics)
    ref = st.api_replay(n, sz["batch"], agg="count", num_keys=keys)
    fired, twice = columnar_fired(sink.results, keys)
    off_fired, _ = columnar_fired(off_sink.results, keys)
    parity, checked = st.parity(ref.fired, fired)
    rows_equal_off = (sorted(fired) == sorted(off_fired)
                      and all(np.array_equal(fired[j], off_fired[j]) for j in fired))
    window, sink_uid = _operator(snap, "window_aggregate"), _operator(snap, "sink")
    op = f"job.operator.{window}"
    sections = (calls.counts["process_raw_batch"] + calls.counts["process_watermark"]
                + calls.counts["drain_output"])
    em = snap[f"{op}.emissionLatencyMs"]
    latency_counts = {k.split(".")[2]: v["count"] for k, v in snap.items()
                      if k.endswith(".latencyMs")}
    spans = client.span_log.spans
    completed = sum(1 for s in spans if (s.scope, s.name) == ("checkpointing", "Checkpoint")
                    and s.attributes.get("status") == "COMPLETED")
    reports = {name: getattr(client, name)() for name in REPORT_KEYS}
    wall_ms = on["seconds"] * 1e3
    checks = {
        "rows_equal_planes_off": rows_equal_off and not twice,
        "parity_vs_oracle": parity,
        "job_numRecordsIn": snap["job.numRecordsIn"] == n,
        "window_numRecordsIn": snap[f"{op}.numRecordsIn"] == n,
        "sink_numRecordsIn": snap[f"job.operator.{sink_uid}.numRecordsIn"] == len(sink.results),
        "latency_histograms": (set(latency_counts) == {window, sink_uid}
                               and all(c > 0 for c in latency_counts.values())),
        "emission_count_is_fires": em["count"] == calls.counts["_emit"] > 0,
        "p99_finite_positive": bool(np.isfinite(snap["job.p99EmissionLatencyMs"])
                                    and snap["job.p99EmissionLatencyMs"] > 0),
        "device_time_within_wall": 0 < snap["job.deviceTimeMsTotal"] <= wall_ms,
        "device_dispatches_are_sections": snap[f"{op}.deviceDispatches"] == sections > 0,
        "checkpoint_gauges": (snap["job.numberOfCompletedCheckpoints"]
                              == client.checkpoint_stats.gauge_values()[
                                  "numberOfCompletedCheckpoints"]
                              == client.num_checkpoints > 0),
        "checkpoint_spans": completed == client.num_checkpoints,
        "reports_have_the_jax_keys": all(sorted(reports[k]) == v
                                         for k, v in REPORT_KEYS.items()),
        "history_sampled": reports["history_report"]["sample_count"] > 1,
        "k1_launched": on["k1_launches"] > 0 and off["k1_launches"] > 0,
    }
    return {"ok": all(checks.values()), "checks": checks, "events": n,
            "windows_checked": checked, "seconds": on["seconds"],
            "tuples_per_s": n / on["seconds"], "off_tuples_per_s": n / off["seconds"],
            "k1_launches": on["k1_launches"], "off_k1_launches": off["k1_launches"],
            "checkpoints": client.num_checkpoints, "fires": calls.counts["_emit"],
            "sections": dict(calls.counts), "latency_counts": latency_counts,
            "emission": {k: v for k, v in em.items() if not k.startswith("b")},
            "p99EmissionLatencyMs": snap["job.p99EmissionLatencyMs"],
            "deviceTimeMsTotal": snap["job.deviceTimeMsTotal"], "wall_ms": wall_ms,
            "deviceDispatches": snap[f"{op}.deviceDispatches"],
            "span_counts": dict(collections_counter((s.scope, s.name) for s in spans)),
            "history_samples": reports["history_report"]["sample_count"],
            "history_sample_ms": reports["history_report"]["sample_time_ms"],
            "doctor_verdict": reports["doctor_report"]["verdict"],
            "latency_report_samples": reports["latency_report"]["samples"]}


def collections_counter(items) -> dict:
    import collections

    return {f"{a}.{b}": c for (a, b), c in collections.Counter(items).items()}


def metrics_main_thread_run(sz, conf=None, dev=DEV) -> float:
    """The cost job driven on the calling thread through the MiniCluster's
    own job loop (`MiniCluster._run_job`, what execute_async's job thread
    runs), so cProfile, which sees only its own thread, sees the planes'
    host work: seconds."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.minicluster import JobClient, MiniCluster

    env = metrics_job(sz["events"], timed_collect_sink(), sz,
                      conf=dict(conf or {}, **{"observability.latency-markers.interval-ms": 0,
                                               "observability.history.interval-ms": 1000}),
                      dev=dev)
    client = JobClient("profile", "api_metrics")
    _sync(dev)
    t0 = time.perf_counter()
    MiniCluster()._run_job(client, plan(env._sinks), env.config, None, torch.device(dev))
    _sync(dev)
    assert client.status().value == "FINISHED", client.error
    return time.perf_counter() - t0


def metrics_leg_b(sz, dev) -> dict:
    """What the planes cost: the job with the defaults (every plane on at
    the JAX package's defaults) against every plane off, in the order off,
    on, on, off, checkpoints off; then the deviceTimeMsTotal gauge beside
    the profiler's device-busy time of one run with the defaults."""
    n = sz["events"]
    defaults = {"observability.latency-markers.interval-ms": 0,
                "observability.history.interval-ms": 1000}
    runs = []
    for label in ("off", "on", "on", "off"):
        r = ckpt_run(metrics_job(n, timed_collect_sink(), sz,
                                 conf=METRICS_OFF if label == "off" else defaults, dev=dev), dev)
        runs.append({"planes": label, "seconds": r["seconds"], "tuples_per_s": n / r["seconds"],
                     "k1_launches": r["k1_launches"]})
    mean = {lab: float(np.mean([r["tuples_per_s"] for r in runs if r["planes"] == lab]))
            for lab in ("on", "off")}
    box = {}

    def profiled():
        r = ckpt_run(metrics_job(n, timed_collect_sink(), sz, conf=defaults, dev=dev), dev)
        box["gauge_ms"] = metrics_snapshot_of(r["client"].metrics)["job.deviceTimeMsTotal"]
        box["k1"] = r["k1_launches"]
        return r["seconds"]

    prof = profile_run("api_metrics_defaults", profiled)
    prof["deviceTimeMsTotal_ms"] = box["gauge_ms"]
    prof["gauge_over_device_busy"] = box["gauge_ms"] / max(prof["device_busy_us"] / 1e3, 1e-9)
    return {"ok": all(r["k1_launches"] > 0 for r in runs) and box["k1"] > 0,
            "events": n, "runs": runs, "on_tuples_per_s": mean["on"],
            "off_tuples_per_s": mean["off"], "on_over_off": mean["on"] / mean["off"],
            "profile_run": prof}


def _runtime_metrics(env, dev):
    """Run env's job through JobRuntime (what env.execute() runs), the
    launch counts at 0 just before it: (snapshot, runtime, seconds)."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops import join_ring
    from flink_tpu_torch.runtime.executor import JobRuntime

    rt = JobRuntime(plan(env._sinks), env.config, dev)
    _sync(dev)
    cs.reset_launch_counts()
    cuda_session.reset_launch_counts()
    join_ring.reset_call_counts()
    t0 = time.perf_counter()
    rt.run()
    _sync(dev)
    secs = time.perf_counter() - t0
    return metrics_snapshot_of(rt.registry), rt, secs


def _launches() -> dict:
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops import join_ring

    return {"k1_superscan": cs.LAUNCHES["k1_superscan"], **cuda_session.LAUNCHES,
            **{f"b5_{k}": v for k, v in join_ring.CALLS.items()}}


def _leaves(snap, uid):
    p = f"job.operator.{uid}."
    return {k[len(p):]: v for k, v in snap.items() if k.startswith(p)}


def metrics_leg_c(sz, dev) -> dict:
    """The other runner families at small sizes, each with its gauge
    family and its emission count against what the run fired."""
    import tempfile

    from flink_tpu_torch.runtime.tpu_window_operator import TpuWindowOperator

    out = {}
    # NEXMark q8 at api_join leg A's defaults: the join gauge family
    env, jsink = join_env(API_JOIN["events"], "q8", API_JOIN, sink=rows_sink(), dev=dev)
    snap, rt, secs = _runtime_metrics(env, dev)
    (runner,) = [r for r in rt.runners if type(r).__name__ == "DeviceJoinRunner"]
    g = _leaves(snap, runner.uid)
    rows = sum(len(v) for v, _t in jsink.batches)
    windows = len({int(t) for _v, ts in jsink.batches for t in ts})
    out["join_q8"] = {
        "seconds": secs, "launches": _launches(), "rows": rows, "windows_with_matches": windows,
        "gauges": {k: g[k] for k in ("joinRingOccupancy", "joinMatchesEmitted",
                                      "joinFallbackReason", "stateBytes", "stateKeyCount",
                                      "numLateRecordsDropped", "currentWatermark")},
        "emission_count": g["emissionLatencyMs"]["count"],
        "ok": bool(g["joinMatchesEmitted"] == rows > 0 and g["joinFallbackReason"] == 0
                   and g["stateBytes"] > 0 and g["emissionLatencyMs"]["count"] == windows
                   and _launches()["b5_join_match"] > 0)}
    # the tiered job at api_tiered leg A's size: the tier gauge family
    with tempfile.TemporaryDirectory(prefix="api_metrics_tier_") as tmp:
        env, _s = tiered_job(sz["tiered_events"], sz["tiered_keys"], False, API_TIERED,
                             tiered=True, cap=sz["tiered_hot"], tmp=tmp, dev=dev)
        snap, rt, secs = _runtime_metrics(env, dev)
    uid = _operator(snap, "window_aggregate")
    g = _leaves(snap, uid)
    tier = {k: g[k] for k in ("vocabSize", "residentKeys", "evictions", "promotions",
                              "spilledBytes", "changelogBytes", "tierHotFillRatio")}
    out["tiered"] = {"seconds": secs, "launches": _launches(), "gauges": tier,
                     "emission_count": g["emissionLatencyMs"]["count"],
                     "ok": bool(tier["evictions"] > 0 and tier["residentKeys"] <= sz["tiered_hot"]
                                and g["emissionLatencyMs"]["count"] > 0
                                and _launches()["k1_superscan"] > 0)}
    # latency mode on the api_ysb program: the controller's gauge family
    runtime, _op, _sink = latency_runtime(sz["latency_events"], True, API_LATENCY, dev)
    _sync(dev)
    from flink_tpu_torch.ops import cuda_superscan as cs

    cs.reset_launch_counts()
    t0 = time.perf_counter()
    runtime.run()
    _sync(dev)
    secs = time.perf_counter() - t0
    snap = metrics_snapshot_of(runtime.registry)
    g = _leaves(snap, _operator(snap, "window_aggregate"))
    lat = {k: g[k] for k in ("latencyModeActive", "currentBatchRung", "inflightDepth",
                             "ladderRecompiles")}
    out["latency_mode"] = {"seconds": secs, "k1_launches": cs.LAUNCHES["k1_superscan"],
                           "gauges": lat, "emission_count": g["emissionLatencyMs"]["count"],
                           "ok": bool(lat["latencyModeActive"] == 1
                                      and lat["currentBatchRung"] >= 1
                                      and g["emissionLatencyMs"]["count"] > 0
                                      and cs.LAUNCHES["k1_superscan"] > 0)}
    # a per-batch lateness job: one stamp a fired window
    lsz = dict(API_LATENESS, events=sz["lateness_events"])
    env, lsink, _late = api_lateness_job(lsz["events"], lsz, dev)
    with _CallCounts(TpuWindowOperator, ("_emit_window",)) as fires:
        snap, rt, secs = _runtime_metrics(env, dev)
    g = _leaves(snap, _operator(snap, "window_aggregate"))
    out["per_batch"] = {"seconds": secs, "fired_windows": fires.counts["_emit_window"],
                        "emission_count": g["emissionLatencyMs"]["count"],
                        "late_dropped": g["numLateRecordsDropped"],
                        "ok": bool(g["emissionLatencyMs"]["count"]
                                   == fires.counts["_emit_window"] > 0)}
    # a session job: one stamp a merged session, each one row
    env, ssink = session_api_job(sz["session_events"], API_SESSIONS, dev)
    snap, rt, secs = _runtime_metrics(env, dev)
    g = _leaves(snap, _operator(snap, "window_aggregate"))
    sessions = sum(len(v) for v, _t in ssink.batches)
    launches = _launches()
    out["session"] = {"seconds": secs, "sessions": sessions, "launches": launches,
                      "emission_count": g["emissionLatencyMs"]["count"],
                      "ok": bool(g["emissionLatencyMs"]["count"] == sessions > 0
                                 and launches["k3_session_ingest"]
                                 + launches["k3_session_ingest_atomic"] > 0
                                 and launches["k4_session_merge"] > 0)}
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def api_metrics_phase(dev=DEV, sizes=None) -> dict:
    """Phase 25: legs A, B and C (see API_METRICS)."""
    sz = dict(API_METRICS, **(sizes or {}))
    out = {"phase": "api_metrics"}
    for leg, fn in (("leg_a", metrics_leg_a), ("leg_b", metrics_leg_b),
                    ("leg_c", metrics_leg_c)):
        t0 = time.perf_counter()
        out[leg] = fn(sz, dev)
        out[leg]["leg_s"] = time.perf_counter() - t0
    out["ok"] = bool(out["leg_a"]["ok"] and out["leg_b"]["ok"] and out["leg_c"]["ok"])
    return out


# ---------------------------------------------------------------------------
# phase 26: the device plane (bench.py::device_plane_microbench's YSB
# program): compile tracker, roofline, key statistics and K1's phase
# counters over a default fused job, the ring-doubling recompile, what the
# plane costs, the mesh, and the profiler capture
# ---------------------------------------------------------------------------

API_DEVICE = dict(keys=8192, batch=8192, superbatch_steps=8, events=1 << 22,
                  cold_events=1 << 16, mesh_events=1 << 20, shards=4,
                  profiler_events=1 << 16)
# the card's figures that bound() uses, so the roofline gauge and the
# kernel table speak one unit (the package's default is the JAX table's
# gpu row)
DEVICE_PEAKS = {"observability.device.hbm-gbps": HBM_BYTES_PER_S / 1e9,
                "observability.device.peak-tflops": SCALAR_OPS_PER_S / 1e12}
DEVICE_OFF = {"observability.device.enabled": False}
# the JAX package's /jobs/:id/device payload (flink_tpu/runtime/executor.py
# device_snapshot, flink_tpu/metrics/device_stats.py, key_stats.py)
DEVICE_PAYLOAD_KEYS = {
    "payload": ["compile", "enabled", "operators", "profiler"],
    "compile": ["compileTimeMsTotal", "events", "numCompiles", "numRecompiles", "programs",
                "recompileStorm"],
    "operator": ["compile", "deviceDispatches", "deviceTimeMsTotal", "flopsUtilizationPct",
                 "hbmUtilizationPct", "keys", "phases"],
    "keys": ["activeKeys", "hotKeys", "keyGroupLoad", "keyGroupStateBytes", "keySkew",
             "maxKeyLoad", "meshLoadSkew", "numKeyGroups", "perDevice",
             "totalRecordsResident"],
    "phases": ["fireSteps", "ingestRecords", "purgeSteps"],
    "profiler": ["captures", "enabled", "last_capture_dir"],
}
# the keys of a fused dispatch's signature (the JAX pipeline's _signature)
SIGNATURE_KEYS = {"K", "S", "NSB", "F", "R", "dtype", "T", "B"}


class _PlannedPhases:
    """Sums, over every plan a FusedWindowPipeline builds while active, the
    fire slots the planner set (fire_valid) and the steps it planned to
    purge (a 0 in the purge row): what K1's phase counters must count."""

    def __enter__(self):
        from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline

        self.cls = FusedWindowPipeline
        self.saved = FusedWindowPipeline._to_device_plan
        self.fires = self.purges = 0

        def wrap(pipe, arrays, fires, _f=self.saved):
            self.fires += int(arrays[2].sum())
            self.purges += int((arrays[4] == 0).any(axis=1).sum())
            return _f(pipe, arrays, fires)

        FusedWindowPipeline._to_device_plan = wrap
        return self

    def __exit__(self, *exc):
        self.cls._to_device_plan = self.saved
        return False


def device_job(n: int, sink, sz, *, conf=None, dev=DEV):
    """env of device_plane_microbench's program over n records: a traceable
    filter keeping one record in three, a traceable key over sz["keys"]
    keys, 10 s windows sliding by 1 s, count; batch sz["batch"],
    sz["superbatch_steps"] steps a dispatch, columnar output, the device
    plane at its defaults with the card's roofline figures. The UDFs are
    new objects every call (as the JAX bench makes them): the chained
    program's cache key holds them, so each job's first dispatch of a
    geometry is its own compile."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    opts = {"execution.step.batch-size": sz["batch"], "execution.state.key-capacity": sz["keys"],
            "execution.window.columnar-output": True,
            "execution.window.superbatch-steps": sz["superbatch_steps"], **DEVICE_PEAKS}
    opts.update(conf or {})
    env = StreamExecutionEnvironment(Configuration(opts), device=dev)
    keys = sz["keys"]
    (env.from_source(DataGeneratorSource(lambda idx: Batch(*st.api_columns(idx, n, keys)), n),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
        .filter(lambda col: col[:, 1] < 0.5, traceable=True)
        .key_by(lambda col: col[:, 0].to(torch.int32), traceable=True)
        .window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
        .aggregate("count").sink_to(sink))
    return env


def _window_runner(rt):
    (r,) = [r for r in rt.runners if getattr(r, "device_stats", None) is not None]
    return r


def _signature_keys(sig: str) -> set:
    return {kv.split("=", 1)[0] for kv in sig.split(",")}


def _tree_keys(dev_snap: dict, uid: str) -> dict:
    entry = dev_snap["operators"][uid]
    return {"payload": sorted(dev_snap), "compile": sorted(dev_snap["compile"]),
            "operator": sorted(entry), "keys": sorted(entry["keys"]),
            "phases": sorted(entry["phases"]), "profiler": sorted(dev_snap["profiler"])}


def device_leg_a(sz, dev) -> dict:
    """The JAX scenario: the job through execute_async with the defaults;
    its rows against the plane-off job's and the numpy model; the phase
    counters against the filter's survivors and the planner's fire slots
    and purge steps; compiles and their signatures and spans; key skew;
    the roofline gauge beside the same bytes over the profiler's device
    time; the device_snapshot() payload's keys. Then the first job after a
    cold build of K1's library: the nvcc build inside compileTimeMsTotal."""
    import tempfile

    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["events"], sz["keys"]
    sink = timed_collect_sink()
    with _PlannedPhases() as planned:
        on = ckpt_run(device_job(n, sink, sz, dev=dev), dev)
    off_sink = timed_collect_sink()
    off = ckpt_run(device_job(n, off_sink, sz, conf=DEVICE_OFF, dev=dev), dev)
    client = on["client"]
    rt = client._runtime
    snap = metrics_snapshot_of(client.metrics)
    off_snap = metrics_snapshot_of(off["client"].metrics)
    uid = _window_runner(rt).uid
    op = f"job.operator.{uid}"
    dev_snap = rt.device_snapshot()
    entry = dev_snap["operators"][uid]
    ref = st.api_replay(n, sz["batch"], agg="count", num_keys=keys)
    fired, twice = columnar_fired(sink.results, keys)
    off_fired, _ = columnar_fired(off_sink.results, keys)
    parity, checked = st.parity(ref.fired, fired)
    events = dev_snap["compile"]["events"]
    compile_spans = sum(1 for s in client.span_log.spans
                        if (s.scope, s.name) == ("device", "XlaCompile"))
    phases = {k: snap[f"{op}.{k}"] for k in ("phaseIngestRecords", "phaseFireSteps",
                                              "phasePurgeSteps")}
    skew, hbm = snap.get("job.keySkew"), snap[f"{op}.hbmUtilizationPct"]
    checks = {
        "rows_equal_plane_off": (not twice and sorted(fired) == sorted(off_fired)
                                 and all(np.array_equal(fired[j], off_fired[j]) for j in fired)),
        "parity_vs_model": parity,
        "ingest_is_filter_survivors": phases["phaseIngestRecords"] == -(-n // 3),
        "fires_are_planned_slots": phases["phaseFireSteps"] == planned.fires > 0,
        "purges_are_planned_steps": phases["phasePurgeSteps"] == planned.purges > 0,
        "compiled": snap["job.device.numCompiles"] >= 1,
        "signatures_have_the_jax_keys": bool(events) and all(
            SIGNATURE_KEYS <= _signature_keys(e["signature"]) for e in events),
        "one_span_per_compile": compile_spans == snap["job.device.numCompiles"],
        "key_skew_uniform": skew is not None and 1.0 <= skew <= 1.5,
        "active_keys_within_capacity": 0 < snap[f"{op}.activeKeys"] <= keys,
        "hbm_pct_in_range": 0.0 < hbm <= 100.0,
        "payload_has_the_jax_keys": _tree_keys(dev_snap, uid) == DEVICE_PAYLOAD_KEYS,
        "plane_off_registers_none": not any(k.startswith("job.device.") for k in off_snap),
        "k1_launched": on["k1_launches"] > 0 and off["k1_launches"] > 0,
    }
    out = {"events": n, "windows_checked": checked, "seconds": on["seconds"],
           "off_seconds": off["seconds"], "tuples_per_s": n / on["seconds"],
           "off_tuples_per_s": n / off["seconds"], "k1_launches": on["k1_launches"],
           "phases": phases, "planned": {"fires": planned.fires, "purges": planned.purges},
           "numCompiles": snap["job.device.numCompiles"],
           "numRecompiles": snap["job.device.numRecompiles"],
           "compileTimeMsTotal": snap["job.device.compileTimeMsTotal"],
           "compile_events": [{k: e.get(k) for k in ("program", "signature", "cause",
                                                    "duration_ms", "cost")} for e in events],
           "keySkew": skew, "activeKeys": snap[f"{op}.activeKeys"],
           "hotKeys": entry["keys"]["hotKeys"][:3],
           "hbmUtilizationPct": hbm, "flopsUtilizationPct": snap[f"{op}.flopsUtilizationPct"],
           "deviceTimeMsTotal": snap["job.deviceTimeMsTotal"]}
    # the roofline's numerator over the profiler's device time, for the same
    # run (the gauge's denominator is DeviceTimer's host-clock time)
    box = {}

    def profiled():
        r = ckpt_run(device_job(n, timed_collect_sink(), sz, dev=dev), dev)
        runner = _window_runner(r["client"]._runtime)
        box["bytes"] = runner.device_stats.bytes_accessed_total()
        box["gauge"] = runner.device_roofline()["hbmUtilizationPct"]
        box["timer_ms"] = runner.device_timer.total_s * 1e3
        return r["seconds"]

    prof = profile_run("api_device_on", profiled)
    busy_s = prof["device_busy_us"] / 1e6
    out["profile"] = {k: prof[k] for k in ("wall_s", "device_busy_us", "device_busy_share",
                                           "k1_device_us", "top")}
    out["roofline"] = {
        "bytes": box["bytes"], "gauge_hbm_pct": box["gauge"], "timer_ms": box["timer_ms"],
        "device_busy_ms": busy_s * 1e3,
        "bytes_over_device_time_pct": box["bytes"] / max(busy_s, 1e-12) / HBM_BYTES_PER_S * 100,
        "timer_over_device_busy": box["timer_ms"] / max(busy_s * 1e3, 1e-9)}
    # the first job after a cold build: K1's library built anew into a
    # temporary directory inside the job's first dispatch
    saved_dir = cs.BUILD_DIR
    with tempfile.TemporaryDirectory(prefix="api_device_build_") as tmp:
        cs.BUILD_DIR = Path(tmp)
        cs._library.cache_clear()
        try:
            cold = ckpt_run(device_job(sz["cold_events"], timed_collect_sink(), sz, dev=dev),
                            dev)
        finally:
            cs.BUILD_DIR = saved_dir
            cs._library.cache_clear()
        cold_snap = metrics_snapshot_of(cold["client"].metrics)
    out["cold_build"] = {
        "events": sz["cold_events"], "seconds": cold["seconds"],
        "numCompiles": cold_snap["job.device.numCompiles"],
        "compileTimeMsTotal": cold_snap["job.device.compileTimeMsTotal"],
        "first_compile_ms": cold["client"]._runtime.device_snapshot()["compile"]["events"][0][
            "duration_ms"]}
    checks["cold_build_in_compile_time"] = (out["cold_build"]["compileTimeMsTotal"]
                                            > out["compileTimeMsTotal"])
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


def device_leg_b(dev) -> dict:
    """Recompile causes: bench.py's ring-doubling sequence on a
    FusedWindowOperator (1 s tumbling count, key capacity 1024, 4 steps a
    dispatch, 12 batches of 512 keys widening from 512 to 1536)."""
    from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
    from flink_tpu_torch.core.time import MAX_WATERMARK
    from flink_tpu_torch.metrics.device_stats import CompileTracker
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator

    cs.reset_launch_counts()
    op = FusedWindowOperator(TumblingEventTimeWindows.of(1000), "count", key_capacity=1 << 10,
                             superbatch_steps=4, chunk=256, device=dev)
    tracker = CompileTracker()
    op.attach_device_stats(tracker)
    rng = np.random.default_rng(7)
    for s in range(12):
        hi = 512 if s < 6 else 1536
        keys = rng.integers(0, hi, 512)
        op.process_batch(keys, np.ones(512, np.float32), np.full(512, s * 300, np.int64))
        op.process_watermark(s * 300)
    op.process_watermark(MAX_WATERMARK)
    rows = op.drain_output()
    events = tracker.events()
    causes = sorted({e["cause"] for e in events if e.get("recompile")})
    tail = [e for e in events if e["cause"] == "batch-geometry"]
    return {"causes": causes, "num_compiles": tracker.num_compiles,
            "num_recompiles": tracker.num_recompiles, "rows": len(rows),
            "phases": op.phase_totals(), "k1_launches": cs.LAUNCHES["k1_superscan"],
            "events": [{k: e[k] for k in ("signature", "cause", "duration_ms")} for e in events],
            "tail_batch_geometry": tail[-1] if tail else None,
            "ok": "ring-doubling" in causes and op.phase_totals()["ingestRecords"] == 12 * 512
            and cs.LAUNCHES["k1_superscan"] > 0}


def device_leg_c(sz, dev) -> dict:
    """What the plane costs: leg A's job with the plane on and off, in the
    order off, on, on, off (execute_async); the median ratio; then one
    on-run's host profile (env.execute() on this thread)."""
    n = sz["events"]
    runs = []
    for label in ("off", "on", "on", "off"):
        r = ckpt_run(device_job(n, timed_collect_sink(), sz,
                                conf=DEVICE_OFF if label == "off" else None, dev=dev), dev)
        runs.append({"plane": label, "seconds": r["seconds"], "tuples_per_s": n / r["seconds"],
                     "k1_launches": r["k1_launches"]})
    med = {lab: float(np.median([r["tuples_per_s"] for r in runs if r["plane"] == lab]))
           for lab in ("on", "off")}

    def on_main_thread():
        env = device_job(n, timed_collect_sink(), sz, dev=dev)
        _sync(dev)
        t0 = time.perf_counter()
        env.execute()
        _sync(dev)
        return time.perf_counter() - t0

    return {"events": n, "runs": runs, "on_tuples_per_s": med["on"],
            "off_tuples_per_s": med["off"], "on_over_off": med["on"] / med["off"],
            "host_profile": host_profile("api_device_on", on_main_thread, top=16),
            "ok": all(r["k1_launches"] > 0 for r in runs)}


def device_leg_d(sz, dev) -> dict:
    """The mesh: api_mesh leg A's job on four shards of the card with the
    plane on, beside the one-card job: keySkewPerDevice per shard, the
    shards' ingest count summed against the card's, K1 once per shard."""
    from flink_tpu_torch.parallel import mesh as mesh_lib

    n = sz["mesh_events"]
    real_visible = mesh_lib.visible_devices
    mesh_shards(sz["shards"], dev)
    out = {}
    try:
        for name, shards in (("card", 0), ("mesh", sz["shards"])):
            env, sink = mesh_job(n, API_MESH, shards=shards, dev=dev)
            snap, rt, secs = _runtime_metrics(env, dev)
            launches = _launches()["k1_superscan"]
            uid = _window_runner(rt).uid
            leaves = _leaves(snap, uid)
            out[name] = {"seconds": secs, "k1": launches,
                         "phases": {k: leaves[k] for k in ("phaseIngestRecords",
                                                           "phaseFireSteps", "phasePurgeSteps")},
                         "keySkew": leaves.get("keySkew"),
                         "keySkewPerDevice": leaves.get("keySkewPerDevice"),
                         "meshLoadSkew": leaves.get("meshLoadSkew"),
                         "fired": api_fired(sink, API["window"], API["slide"])}
    finally:
        mesh_lib.visible_devices = real_visible
    card, mesh = out["card"], out["mesh"]
    per_dev = mesh["keySkewPerDevice"] or {}
    checks = {
        "rows_equal": _fired_equal(card.pop("fired"), mesh.pop("fired")),
        "skew_per_device": len(per_dev) == sz["shards"],
        "ingest_summed_equals_card": (mesh["phases"]["phaseIngestRecords"]
                                      == card["phases"]["phaseIngestRecords"] == -(-n // 3)),
        "k1_once_per_shard": card["k1"] > 0 and mesh["k1"] == sz["shards"] * card["k1"],
    }
    return {"events": n, **out, "checks": checks, "ok": all(checks.values())}


def device_leg_e(sz, dev) -> dict:
    """The profiler: one small fused job with observability.profiler.* into
    a temporary directory; one capture, whose trace names K1's kernels."""
    import os
    import tempfile

    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import JobRuntime

    with tempfile.TemporaryDirectory(prefix="api_device_profile_") as tmp:
        env = device_job(sz["profiler_events"], timed_collect_sink(), sz,
                         conf={"observability.profiler.enabled": True,
                               "observability.profiler.dir": tmp}, dev=dev)
        rt = JobRuntime(plan(env._sinks), env.config, dev)
        rt.run()
        _sync(dev)
        prof = rt.device_snapshot()["profiler"]
        files = os.listdir(tmp)
        names = set()
        for f in files:
            with open(os.path.join(tmp, f)) as fh:
                names |= {str(e.get("name", "")) for e in json.load(fh).get("traceEvents", [])}
    k1 = sorted({nm.split("(")[0][:40] for nm in names if "k1_" in nm})
    return {"profiler": prof, "files": len(files), "k1_kernels_in_trace": k1,
            "ok": bool(prof["captures"] == 1 and prof["last_capture_dir"] == tmp
                       and len(files) == 1 and k1)}


def api_device_phase(dev=DEV, sizes=None) -> dict:
    """Phase 26: legs A-E (see API_DEVICE), each timed."""
    sz = dict(API_DEVICE, **(sizes or {}))
    out = {"phase": "api_device"}
    for leg, fn in (("leg_a", lambda: device_leg_a(sz, dev)), ("leg_b", lambda: device_leg_b(dev)),
                    ("leg_c", lambda: device_leg_c(sz, dev)),
                    ("leg_d", lambda: device_leg_d(sz, dev)),
                    ("leg_e", lambda: device_leg_e(sz, dev))):
        t0 = time.perf_counter()
        out[leg] = fn()
        out[leg]["leg_s"] = time.perf_counter() - t0
    out["ok"] = all(out[leg]["ok"] for leg in ("leg_a", "leg_b", "leg_c", "leg_d", "leg_e"))
    return out


# ---------------------------------------------------------------------------
# phase 27, api_mesh_features: the main path's features on four virtual
# shards of the one card (visible_devices replaced, as in phase 24):
# shared correlated windows (leg A), the tiered state plane (leg B) and
# queryable state and savepoints (leg C) on the mesh, each held against
# the one-card job and a numpy model; then K1 at shard 0's first full
# shared dispatch of leg A's wide group
# ---------------------------------------------------------------------------

API_MESH_FEATURES = dict(
    shards=4, keys=8192, batch=65536, parity_events=1 << 19, timed_events=1 << 22, runs=2,
    warmup_events=1 << 17, wide_keys=1 << 20, wide_events=1 << 22,
    tier_batch=8192, tier_parity_events=1 << 15, tier_parity_keys=1 << 15, tier_hot=4096,
    tier_parity_admission=1, tier_events=1 << 17, tier_keys=10_000_000, tier_admission=2,
    zipf_s=1.0, row_keys=1 << 20, row_slices=32, row_moves=1 << 16,
    query_keys=64, query_events=1 << 18, query_batch=8192, savepoint_at=0.5)


def _member_fires_equal(a: list, b: list) -> bool:
    """Columnar runs, sink by sink: fires equal array for array, none empty."""
    return len(a) == len(b) and all(len(x) > 0 and _fires_equal(x, y) for x, y in zip(a, b))


def features_leg_a(sz, dev) -> dict:
    """Sharing on the mesh (correlated_windows_microbench's program).

    Row mode at parity_events: the shared mesh job, the independent mesh
    job (shared-partials off), the shared one-card job and the numpy
    model, window by window. Columnar at timed_events, interleaved, best of
    `runs`: shared and independent on the mesh, shared on the card, with
    K1's launches (n_shards a shared mesh dispatch). Then phase 20's
    five-member group (F = 20) at wide_keys, wide_events records, on the
    mesh and on the card, equal array for array."""
    n_sh = sz["shards"]
    n = sz["parity_events"]
    for mesh in (n_sh, 0):     # builds, warms
        correlated_run(sz["warmup_events"], True, columnar=True, mesh=mesh, sz=sz, dev=dev)
    runs = {name: correlated_run(n, shared, columnar=False, mesh=mesh, sz=sz, dev=dev)
            for name, shared, mesh in (("mesh_shared", True, n_sh),
                                       ("mesh_independent", False, n_sh),
                                       ("card_shared", True, 0))}
    members, parity = [], True
    for i, m in enumerate(DASHBOARD):
        got = {name: correlated_rows(r["sinks"][i]) for name, r in runs.items()}
        model = correlated_model(n, sz["keys"], m)
        ok = len(model) > 0 and all(g == model for g in got.values())
        parity = parity and ok
        members.append({"member": list(m), "parity": ok, "rows": len(model),
                        "windows_checked": len({t for t, _k in model})})
    selected = (_shared_selected(runs["mesh_shared"]["kinds"], len(DASHBOARD))
                and runs["mesh_shared"]["mesh_devices"] == [n_sh]
                and runs["mesh_independent"]["kinds"].count("DeviceChainRunner")
                == len(DASHBOARD)
                and runs["mesh_independent"]["mesh_devices"] == [n_sh]
                and runs["card_shared"]["mesh_devices"] == [1])
    out = {"events": n, "parity": parity, "members": members, "shared_selected": selected,
           "parity_k1_launches": {k: r["k1_launches"] for k, r in runs.items()}}
    del runs
    nt = sz["timed_events"]
    variants = {"card_shared": (True, 0), "mesh_shared": (True, n_sh),
                "mesh_independent": (False, n_sh)}
    order = list(variants) + list(reversed(list(variants)))
    timed = {name: [] for name in variants}
    for _ in range(max(1, sz["runs"] // 2)):
        for name in order:
            shared, mesh = variants[name]
            r = correlated_run(nt, shared, columnar=True, mesh=mesh, sz=sz, dev=dev)
            timed[name].append({k: r[k] for k in ("seconds", "tuples_per_s", "k1_launches")})
    for name, rs in timed.items():
        out[f"{name}_tuples_per_s"] = max(r["tuples_per_s"] for r in rs)
    out["timed_events"] = nt
    out["timed"] = timed
    out["k1_launches"] = {name: rs[0]["k1_launches"] for name, rs in timed.items()}
    card_k1 = out["k1_launches"]["card_shared"]
    out["k1_per_shared_dispatch_ratio"] = out["k1_launches"]["mesh_shared"] / max(card_k1, 1)
    out["shared_over_independent_on_mesh"] = (out["mesh_shared_tuples_per_s"]
                                              / out["mesh_independent_tuples_per_s"])
    out["mesh_over_card_shared"] = (out["mesh_shared_tuples_per_s"]
                                    / out["card_shared_tuples_per_s"])
    # the wide group at full width
    wide = {}
    for name, mesh in (("mesh", n_sh), ("card", 0)):
        r = correlated_run(sz["wide_events"], True, columnar=True, members=DASHBOARD_WIDE,
                           keys=sz["wide_keys"], mesh=mesh, sz=sz, dev=dev)
        wide[name] = {"fires": [correlated_fires(x) for x in r["sinks"]],
                      **{k: r[k] for k in ("seconds", "tuples_per_s", "k1_launches",
                                           "kinds", "mesh_devices")}}
        del r
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    kept = len(range(0, sz["wide_events"], 3))
    totals_ok = all(sum(int(f[3].sum()) for f in fires)
                    == kept * (1 if m[0] == "tumbling" else m[1] // m[2])
                    for m, fires in zip(DASHBOARD_WIDE, wide["mesh"]["fires"]))
    out["wide"] = {
        "events": sz["wide_events"], "keys": sz["wide_keys"],
        "count_ring_bytes": sz["wide_keys"] * 128 * 4,
        "equal": _member_fires_equal(wide["mesh"]["fires"], wide["card"]["fires"]),
        "totals_ok": totals_ok,
        "selected": (_shared_selected(wide["mesh"]["kinds"], len(DASHBOARD_WIDE))
                     and wide["mesh"]["mesh_devices"] == [n_sh]),
        "fires": [len(f) for f in wide["mesh"]["fires"]],
        **{name: {k: v[k] for k in ("seconds", "tuples_per_s", "k1_launches")}
           for name, v in wide.items()}}
    out["wide"]["k1_per_shared_dispatch_ratio"] = (out["wide"]["mesh"]["k1_launches"]
                                                   / max(out["wide"]["card"]["k1_launches"], 1))
    del wide
    out["ok"] = bool(
        parity and selected and card_k1 > 0
        and out["k1_launches"]["mesh_shared"] == n_sh * card_k1
        and out["k1_launches"]["mesh_independent"] > 0
        and out["wide"]["equal"] and out["wide"]["totals_ok"] and out["wide"]["selected"]
        and out["wide"]["mesh"]["k1_launches"] == n_sh * out["wide"]["card"]["k1_launches"] > 0)
    return out


def sharded_row_surface(card: str, sz, dev=DEV) -> dict:
    """The sharded row surface at card width: a count ring and one float32
    field ring of [S, K] = [row_slices, row_keys] over n shards, the calls a
    demotion wave and a promotion make (as tiered_row_surface), each equal
    to the one-device pipeline's on the CPU, timed as the tier calls it
    (CUDA events, ids up and rows down included) and as the shards' device
    indexing alone, beside its bytes bound."""
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline
    from flink_tpu_torch.runtime.fused_window_pipeline import FusedWindowPipeline
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms

    S, K, m, n_sh = sz["row_slices"], sz["row_keys"], sz["row_moves"], sz["shards"]
    window = SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS)
    g = torch.Generator().manual_seed(27)
    count0 = torch.randint(0, 64, (K, S), generator=g, dtype=torch.int32).numpy()
    sum0 = torch.randint(0, 1 << 20, (K, S), generator=g, dtype=torch.int32).float().numpy()
    mesh = ShardedFusedPipeline(Mesh([_shard_device(dev)] * n_sh), window, "sum",
                                key_capacity=K, num_slices=S)
    mesh._put_canonical(count0, {"sum": sum0})
    ref = FusedWindowPipeline(window, "sum", key_capacity=K, num_slices=S, device="cpu")
    ref._count.copy_(torch.from_numpy(count0.T))
    ref._state["sum"].copy_(torch.from_numpy(sum0.T))
    del count0, sum0
    rng = np.random.default_rng(27)
    kids = rng.choice(K, m, replace=False).astype(np.int64)
    cell_kids = rng.choice(K, m, replace=False).astype(np.int64)
    cell_spos = rng.integers(0, S, m).astype(np.int64)
    counts = rng.integers(1, 1000, m).astype(np.int64)
    vals = rng.integers(0, 1 << 20, m).astype(np.float64)

    def rings_equal():
        snap = mesh.snapshot()
        return (np.array_equal(snap["count"], ref._count.numpy().T)
                and np.array_equal(snap["state"]["sum"], ref._state["sum"].numpy().T))

    equal = {}
    a, b = mesh.gather_key_rows(kids), ref.gather_key_rows(kids)
    equal["gather_key_rows"] = bool(a[0].shape == (m, S) and np.array_equal(a[0], b[0])
                                    and np.array_equal(a[1]["sum"], b[1]["sum"]))
    for p in (mesh, ref):
        p.clear_key_rows(kids)
    equal["clear_key_rows"] = rings_equal()
    for p in (mesh, ref):
        p.write_cells(cell_kids, cell_spos, counts, {"sum": vals})
    equal["write_cells"] = rings_equal()
    a, b = mesh.gather_cells(cell_kids, cell_spos), ref.gather_cells(cell_kids, cell_spos)
    equal["gather_cells"] = bool(np.array_equal(a[0], b[0]) and np.array_equal(a[0], counts)
                                 and np.array_equal(a[1]["sum"], b[1]["sum"]))
    del ref, a, b
    out = {"shape": f"[S, K] = [{S}, {K}] int32 count + float32 sum over {n_sh} shards "
                    f"of [{S}, {K // n_sh}], {m} rows/cells",
           "card": card, "equal_to_cpu": equal}
    if torch.device(dev).type == "cuda":
        rows = mesh._shard_rows(kids)
        cells = [(j, torch.from_numpy(cell_spos[pos]).to(r.device), r)
                 for j, pos, r in mesh._shard_rows(cell_kids)]
        cnt = {j: torch.ones(len(r), dtype=torch.int32, device=r.device) for j, _s, r in cells}
        val = {j: torch.ones(len(r), dtype=torch.float32, device=r.device)
               for j, _s, r in cells}
        row_bytes = m * S * 8
        calls = {
            "gather_key_rows": (lambda: mesh.gather_key_rows(kids),
                                lambda: [x.index_select(1, r) for j, _p, r in rows
                                         for x in mesh._rings(j)],
                                m * 8 + 2 * row_bytes),
            "clear_key_rows": (lambda: mesh.clear_key_rows(kids),
                               lambda: [x.index_fill_(1, r, 0) for j, _p, r in rows
                                        for x in mesh._rings(j)],
                               m * 8 + row_bytes),
            "write_cells": (lambda: mesh.write_cells(cell_kids, cell_spos, counts,
                                                     {"sum": vals}),
                            lambda: [x.index_put_((sp, r), v) for j, sp, r in cells
                                     for x, v in zip(mesh._rings(j), (cnt[j], val[j]))],
                            m * 16 + m * 8 + m * 8),
            "gather_cells": (lambda: mesh.gather_cells(cell_kids, cell_spos),
                             lambda: [x[sp, r] for j, sp, r in cells for x in mesh._rings(j)],
                             m * 16 + 2 * m * 8),
        }
        for name, (call, device_only, nbytes) in calls.items():
            b_ms, b_by = bound(nbytes, 0)
            out[name] = {"ms": cuda_ms(call, 1), "device_ms": cuda_ms(device_only, 1),
                         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    out["ok"] = all(equal.values())
    return out


def tiered_mesh_checkpointed(n: int, n_keys: int, sz, *, tiered: bool, cap: int,
                             admission: int, mesh: int, interval_ms: int, dev=DEV) -> dict:
    """millikey_microbench's program through execute_async with
    checkpoints every interval_ms (uniform keys; the tier's changelog on):
    sorted rows, K1 launches, checkpoints taken, the operator's mesh size
    and tier payload."""
    import shutil
    import tempfile

    from flink_tpu_torch.ops import cuda_superscan as cs

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tier_mesh_")
    try:
        extra = {"execution.checkpointing.interval": interval_ms,
                 "execution.checkpointing.dir": f"{tmp}/chk"}
        if mesh:
            extra.update({"parallel.mesh.enabled": True, "parallel.mesh.devices": mesh})
        env, sink = tiered_job(n, n_keys, False, dict(sz, admission=admission), tiered=tiered,
                               cap=cap, tmp=tmp, extra=extra, dev=dev)
        _sync(dev)
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        client = env.execute_async("tier-mesh")
        status = client.wait(900).value
        _sync(dev)
        secs = time.perf_counter() - t0
        ops = [r.op for r in client._runtime.runners
               if hasattr(getattr(r, "op", None), "tier_payload")]
        op = ops[0] if ops else None
        return {"rows": sorted((int(k), int(c)) for k, c in sink.results), "status": status,
                "seconds": secs, "k1_launches": cs.LAUNCHES["k1_superscan"],
                "checkpoints": ckpt_stats(client)["checkpoints"],
                "mesh_devices": op.mesh_devices() if op is not None else None,
                "tier": op.tier_payload() if op is not None else None}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def features_leg_b(sz, dev, card: str) -> dict:
    """Tiering on the mesh (millikey_microbench's program).

    sharded_parity: tier_parity_events records over tier_parity_keys keys,
    hot capacity tier_hot, admission 1, checkpoints every 1 ms, on n
    shards: rows equal the untiered mesh job's and the numpy oracle's, with
    evictions. Then tier_events records over tier_keys zipf keys, hot
    capacity tier_hot over the shards: oracle parity, resident keys within
    the hot capacity, records routed cold, the tier's gauges. Then the
    sharded row surface at card width (sharded_row_surface)."""
    from flink_tpu_torch.testing import stream as st

    n_sh = sz["shards"]
    tsz = dict(API_TIERED, batch=sz["tier_batch"], zipf_s=sz["zipf_s"])
    n, keys = sz["tier_parity_events"], sz["tier_parity_keys"]
    kw = dict(cap=sz["tier_hot"], admission=sz["tier_parity_admission"], mesh=n_sh,
              interval_ms=1, dev=dev)
    got = tiered_mesh_checkpointed(n, keys, tsz, tiered=True, **kw)
    ref = tiered_mesh_checkpointed(n, keys, tsz, tiered=False, **kw)
    oracle = st.millikey_oracle(n, keys, False, sz["zipf_s"])
    parity = {"events": n, "keys": keys, "hot_capacity": sz["tier_hot"],
              "rows": len(got["rows"]),
              "parity_vs_untiered": len(got["rows"]) > 0 and got["rows"] == ref["rows"],
              "parity_vs_oracle": got["rows"] == oracle,
              "evictions": got["tier"]["evictions"], "resident_keys": got["tier"]["residentKeys"],
              "checkpoints": {"tiered": got["checkpoints"], "untiered": ref["checkpoints"]},
              "status": [got["status"], ref["status"]],
              "mesh_selected": got["mesh_devices"] == ref["mesh_devices"] == n_sh,
              "k1_launches": {"tiered": got["k1_launches"], "untiered": ref["k1_launches"]},
              "seconds": {"tiered": got["seconds"], "untiered": ref["seconds"]}}
    parity["ok"] = bool(parity["parity_vs_untiered"] and parity["parity_vs_oracle"]
                        and parity["evictions"] > 0 and parity["mesh_selected"]
                        and got["checkpoints"] > 0 and got["k1_launches"] > 0
                        and got["status"] == ref["status"] == "FINISHED")
    del got, ref, oracle
    n = sz["tier_events"]
    oracle = st.millikey_oracle(n, sz["tier_keys"], True, sz["zipf_s"])
    r = tiered_run(n, sz["tier_keys"], True, dict(tsz, admission=sz["tier_admission"]),
                   tiered=True, cap=sz["tier_hot"], expect=oracle,
                   extra={"parallel.mesh.enabled": True, "parallel.mesh.devices": n_sh},
                   dev=dev)
    del oracle
    tier = r["tier"]
    zipf = {"events": n, "keys": sz["tier_keys"], "hot_capacity": sz["tier_hot"],
            "admission_min_count": sz["tier_admission"], "parity": r["equal"],
            "rows": r["num_rows"], "tuples_per_s": r["tuples_per_s"], "seconds": r["seconds"],
            "resident_keys": tier["residentKeys"],
            "resident_bounded": tier["residentKeys"] <= sz["tier_hot"],
            "cold_records": tier["coldRecords"], "evictions": tier["evictions"],
            "gauges": tier, "native": r["native"], "mesh_devices": r["mesh_devices"],
            "k1_launches": r["k1_launches"]}
    zipf["ok"] = bool(zipf["parity"] and zipf["resident_bounded"] and zipf["cold_records"] > 0
                      and zipf["evictions"] > 0 and zipf["mesh_devices"] == n_sh
                      and zipf["k1_launches"] > 0)
    rows = sharded_row_surface(card, sz, dev)
    return {"sharded_parity": parity, "zipf": zipf, "row_surface": rows,
            "ok": bool(parity["ok"] and zipf["ok"] and rows["ok"])}


def features_leg_c(sz, dev) -> dict:
    """Queryable state and savepoints on the mesh.

    query_keys keys' query_state_for on the n-shard host-keyed fused
    operator and on the one-card operator, fed the same batches, at three
    points of the input (some steps buffered, some dispatched). Then a
    savepoint at savepoint_at of leg A's shared mesh program (columnar,
    parity_events), restored on one card and on a 2-shard mesh: each
    member's fires equal the uninterrupted mesh run's."""
    import shutil
    import tempfile

    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.runtime.fused_window_operator import FusedWindowOperator
    from flink_tpu_torch.runtime.minicluster import MiniCluster

    n_sh, K = sz["shards"], sz["keys"]
    window = SlidingEventTimeWindows.of(API["window"], API["slide"])
    ops = {"mesh": FusedWindowOperator(window, "sum", key_capacity=K, chunk=4096,
                                       mesh=Mesh([_shard_device(dev)] * n_sh)),
           "card": FusedWindowOperator(window, "sum", key_capacity=K, chunk=4096, device=dev)}
    n, B = sz["query_events"], sz["query_batch"]
    probe = np.random.default_rng(27).choice(K, sz["query_keys"], replace=False)
    points, equal, seen = [], True, 0
    _sync(dev)
    cs.reset_launch_counts()
    for i, lo in enumerate(range(0, n, B)):
        col, ts = mesh_columns(np.arange(lo, lo + B, dtype=np.int64), n, API_MESH, False)
        keys, vals = col[:, 0].astype(np.int64), (col[:, 1] + 1).astype(np.float32)
        for op in ops.values():
            op.process_batch(keys, vals, ts)
            op.process_watermark(int(ts.max()) - 1)
            op.drain_output()
        if i % 11 == 5:
            views = {name: [op.query_state_for(int(k)) for k in probe]
                     for name, op in ops.items()}
            same = views["mesh"] == views["card"]
            equal = equal and same
            seen += sum(len(v) for v in views["mesh"])
            points.append({"batch": i, "equal": same,
                           "buffered_steps": len(ops["mesh"]._steps)})
    query = {"keys": sz["query_keys"], "events": n, "points": points, "equal": equal,
             "slices_seen": seen, "mesh_devices": ops["mesh"].mesh_devices(),
             "k1_launches": cs.LAUNCHES["k1_superscan"]}
    query["ok"] = bool(equal and seen > 0 and query["mesh_devices"] == n_sh
                       and query["k1_launches"] > 0)
    del ops
    # the savepoint crossing
    n = sz["parity_events"]
    B = sz["batch"]
    half = (int(n * sz["savepoint_at"]) // B) * B

    def fires_of(sinks):
        return [[(int(w.start), int(w.end), np.asarray(ids), np.asarray(v))
                 for (w, ids, v), _t in s.results] for s in sinks]

    def submit(env, name, path=None):
        return MiniCluster.get_shared().submit(plan(env._sinks), env.config, name,
                                               savepoint_restore_path=path, device=dev)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_features_")
    try:
        env, sinks = correlated_env(n, True, columnar=True, mesh=n_sh,
                                    make_sink=timed_collect_sink, sz=sz, dev=dev)
        client = submit(env, "shared-mesh-whole")
        whole = fires_of(sinks) if client.wait(900).value == "FINISHED" else None
        gate = SourceGate(half, hold_at=half + 2 * B)
        env1, _s1 = correlated_env(n, True, columnar=True, mesh=n_sh, hook=gate,
                                   make_sink=timed_collect_sink, sz=sz, dev=dev)
        sp = f"{tmp}/savepoint"
        first = gate.savepoint(submit(env1, "shared-mesh-savepoint"), sp)["first_job"]
        save = {"first_job": first, "at": half}
        ok = first == "CANCELED" and whole is not None
        for name, mesh in (("restored_card", 0), ("restored_mesh2", 2)):
            env2, sinks2 = correlated_env(n, True, columnar=True, mesh=mesh,
                                          make_sink=timed_collect_sink, sz=sz, dev=dev)
            _sync(dev)
            cs.reset_launch_counts()
            client2 = submit(env2, name, sp)
            status = client2.wait(900).value
            got = fires_of(sinks2)
            leader = [r for r in client2._runtime.runners
                      if type(r).__name__ == "SharedWindowRunner"]
            save[name] = {"status": status,
                          "equal_to_uninterrupted": whole is not None
                          and _member_fires_equal(got, whole),
                          "mesh_devices": leader[0].op.mesh_devices() if leader else None,
                          "k1_launches": cs.LAUNCHES["k1_superscan"]}
            ok = ok and (status == "FINISHED" and save[name]["equal_to_uninterrupted"]
                         and save[name]["mesh_devices"] == (mesh or 1)
                         and save[name]["k1_launches"] > 0)
        save["ok"] = bool(ok)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"query": query, "savepoint": save, "ok": bool(query["ok"] and save["ok"])}


def mesh_shared_k1_inputs(sz, dev=DEV):
    """Shard 0's K1 inputs of leg A's wide group's first full mesh dispatch
    (32 steps of `batch` records of the wide_events stream over wide_keys
    keys) after the exchange, made by the sharded pipeline's own staging,
    prologue and routing at the operator's geometry: (shim with shard 0's
    geometry and the planner's per-slot spws, agg, idx, vals, plan)."""
    import types

    from flink_tpu_torch.ops.aggregators import resolve
    from flink_tpu_torch.parallel.mesh import Mesh
    from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline
    from flink_tpu_torch.runtime.fused_window_pipeline import TracedPrologue

    T, B, n, keys = 32, sz["batch"], sz["wide_events"], sz["wide_keys"]
    agg = resolve("count")
    pipe = ShardedFusedPipeline(
        Mesh([_shard_device(dev)] * sz["shards"]), None, agg, key_capacity=keys, nsb=4,
        fires_per_step=4, out_rows=256, chunk=4096,
        assigners=[_member(m) for m in DASHBOARD_WIDE],
        prologue=TracedPrologue((("filter", _t_filter),), _t_key))
    steps, wms = [], []
    for t in range(T):
        col, ts = correlated_columns(np.arange(t * B, (t + 1) * B, dtype=np.int64), n, keys)
        steps.append((col, ts))
        wms.append(int(ts.max()) - 1)
    staged = pipe.stage_superbatch_raw(steps, wms)
    plan = staged[3]
    src_idx, src_vals, _kb = pipe.source_lanes(staged, T)
    idx, vals = pipe.route_lanes(src_idx, src_vals)[0]
    shim = types.SimpleNamespace(S=pipe.S, K=pipe.K_local, R=pipe.R, NSB=pipe.NSB, F=pipe.F,
                                 slot_spws=pipe.slot_spws)
    return shim, agg, idx.reshape(-1), vals, plan


def api_mesh_features_phase(dev=DEV, sizes=None) -> dict:
    """Legs A, B and C over four shards of `dev` (visible_devices replaced
    for the phase, restored after); on the card, K1 against its plain
    version at shard 0's first full shared dispatch of leg A's wide group
    (`k1_mesh_shared`)."""
    from flink_tpu_torch.parallel import mesh as mesh_lib

    sz = dict(API_MESH_FEATURES, **(sizes or {}))
    card = card_line() if torch.device(dev).type == "cuda" else "cpu"
    real = mesh_lib.visible_devices
    mesh_shards(sz["shards"], dev)
    out = {"phase": "api_mesh_features", "shards": sz["shards"],
           "shard_devices": [str(d) for d in mesh_lib.visible_devices(dev)]}
    try:
        for leg, run in (("leg_a", lambda: features_leg_a(sz, dev)),
                         ("leg_b", lambda: features_leg_b(sz, dev, card)),
                         ("leg_c", lambda: features_leg_c(sz, dev))):
            t0 = time.perf_counter()
            out[leg] = run()
            out[leg]["phase_s"] = time.perf_counter() - t0
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
        if torch.device(dev).type == "cuda":
            t0 = time.perf_counter()
            shim, agg, idx, vals, plan = mesh_shared_k1_inputs(sz, dev)
            out["k1_mesh_shared"] = k1_at_dispatch(
                f"api_mesh_features leg A wide group: shard 0 of {sz['shards']}, its "
                "exchanged lanes of the job's first full shared dispatch", shim, agg, idx,
                vals, plan)
            out["k1_mesh_shared"]["seconds"] = time.perf_counter() - t0
            del shim, idx, vals, plan
            torch.cuda.empty_cache()
    finally:
        mesh_lib.visible_devices = real
    out["ok"] = bool(out["leg_a"]["ok"] and out["leg_b"]["ok"] and out["leg_c"]["ok"])
    return out


# ---------------------------------------------------------------------------
# phase 28: api_mesh_control, the mesh's control loops (the skew rebalancer,
# the autoscaler's mesh rescale and the device-loss degrade) over four
# shards of the card, with K1 once per shard under a rebalanced table
# ---------------------------------------------------------------------------

API_MESH_CONTROL = dict(events=1 << 19, keys=8192, batch=2048, superbatch_steps=8, shards=4,
                        zipf_s=1.0, parity_events=1 << 16, threshold=1.2,
                        gate_at=1 << 17, checkpoint_ms=5, fail_at=6, swap_reps=5)


def control_perm(sz) -> np.ndarray:
    """`skew_matrix_microbench`'s hot placement: the top G/n zipf ranks land
    one per key group of shard 0's contiguous range (ids 0, Kg, 2 Kg, ...),
    maximally imbalanced under the static owner function and fully
    splittable by a key-group rebalance; the tail fills the rest of the id
    space in a default_rng(7) permutation."""
    from flink_tpu_torch.parallel.routing import choose_key_groups

    K, n = sz["keys"], sz["shards"]
    G = choose_key_groups(K, n)
    hot = np.arange(G // n, dtype=np.int64) * (K // G)
    rest = np.setdiff1d(np.arange(K, dtype=np.int64), hot)
    return np.concatenate([hot, np.random.default_rng(7).permutation(rest)])


def control_job(n: int, sz, *, skewed=False, shards=0, combine=True, rebalance=False,
                columnar=True, stats=False, conf=None, hook=None, dev=DEV):
    """(env, sink) of skew_matrix_microbench's program: mesh_job's with the
    bench's filter (every record), its zipf placement (`control_perm`) and
    `superbatch_steps` steps a dispatch; with `shards` > 0 the skew
    rebalancer at threshold `threshold` and interval 0 if `rebalance`;
    `stats` turns the device plane's key statistics on with a fold every
    step. The sink keeps each row (or packed fire) with its timestamp, in
    checkpoints too."""
    opts = {"execution.window.superbatch-steps": sz["superbatch_steps"],
            "observability.device.enabled": stats,
            "restart-strategy.type": "fixed-delay", "restart-strategy.initial-backoff": 1}
    if stats:
        opts["observability.device.key-stats.interval-ms"] = 0
    if shards:
        opts.update({"parallel.mesh.skew-rebalance": rebalance,
                     "parallel.mesh.rebalance.skew-threshold": sz["threshold"],
                     "parallel.mesh.rebalance.interval-ms": 0})
    opts.update(conf or {})
    return mesh_job(n, sz, skewed=skewed, shards=shards, combine=combine, columnar=columnar,
                    dev=dev, perm=control_perm(sz) if skewed else None, filt=_t_filter_all,
                    conf=opts, hook=hook, sink=timed_collect_sink())


def mesh_load_skew(runtime):
    """meshLoadSkew of the key statistics' last fold (the device snapshot)."""
    for entry in runtime.device_snapshot()["operators"].values():
        skew = (entry.get("keys") or {}).get("meshLoadSkew")
        if skew is not None:
            return float(skew)
    return None


class ShardScanTap:
    """Installed around ShardedFusedPipeline._scan_shards for one run: counts
    the sharded dispatches (`calls`); raises a RuntimeError carrying the
    device-scoped chaos marker at the `fail_at`-th; with `take_T`, keeps
    (pipeline, source lanes, plan) of the first full dispatch of take_T
    steps under a rebalanced routing table, cloned, for K1's check against
    its plain version. It launches nothing itself."""

    def __init__(self, take_T=None, fail_at=None):
        self.take_T, self.fail_at = take_T, fail_at
        self.calls, self.taken, self._real = 0, None, None

    def __enter__(self):
        from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

        real = self._real = ShardedFusedPipeline._scan_shards

        def scan(pipe, src_idx, src_vals, plan, fires, *a, **kw):
            self.calls += 1
            if self.calls == self.fail_at:
                raise RuntimeError("[chaos-injected:device] shard 1 of the mesh lost")
            r = pipe.routing
            if (self.take_T is not None and self.taken is None and r is not None
                    and r.version >= 1 and not r.is_identity
                    and int(plan[0].shape[0]) == self.take_T):
                self.taken = (pipe, [i.clone() for i in src_idx],
                              [None if v is None else v.clone() for v in src_vals],
                              tuple(p.clone() for p in plan), list(fires))
            return real(pipe, src_idx, src_vals, plan, fires, *a, **kw)

        ShardedFusedPipeline._scan_shards = scan
        return self

    def __exit__(self, *exc):
        from flink_tpu_torch.parallel.sharded_superscan import ShardedFusedPipeline

        ShardedFusedPipeline._scan_shards = self._real
        return False

    def k1_inputs(self):
        """Shard 0's K1 partials-entry inputs of the kept dispatch, made by the
        pipeline's own exchange under its table: (shim, agg, plan, cpart,
        parts)."""
        import types

        pipe, src_idx, src_vals, plan, fires = self.taken
        T = int(plan[0].shape[0])
        cpart, parts = pipe.route_partials(src_idx, src_vals, 0, T)[0]
        shim = types.SimpleNamespace(S=pipe.S, K=pipe.K_local, R=pipe.R, NSB=pipe.NSB, F=pipe.F,
                                     slot_spws=pipe.slot_spws)
        return (shim, pipe.agg, pipe._plan_on(plan, {}, pipe.devices[0]) + (fires,), cpart,
                parts)


def routing_swap(runtime, assign, reps: int, dev=DEV) -> dict:
    """`JobRuntime.set_mesh_routing` on a finished job's runtime, alternating
    the identity table and `assign`, median of `reps` swaps (host clock,
    device synchronised): the canonical state comes back to the host and is
    re-laid under the other table. Bound: the rings read once and written
    once over the card's memory rate."""
    op = next(runtime._routed_ops())
    G, n = op.pipe.routing.G, op.mesh_devices()
    ident = (np.arange(G, dtype=np.int64) * n) // G
    times = []
    for i in range(2 * reps):
        target = assign if i % 2 == 0 else ident
        _sync(dev)
        t0 = time.perf_counter()
        runtime.set_mesh_routing(target)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1000.0)
    ring_bytes = op.state_bytes()
    b_ms, b_by = bound(2 * ring_bytes, 0)
    return {"shape": f"{op.pipe.K} keys over {n} shards, {G} key groups, rings "
                     f"{ring_bytes} bytes", "ms": float(np.median(times)),
            "ms_all": times, "bound_ms": b_ms, "bound_by": b_by,
            "table_version": op.routing_version()}


def control_leg_a(sz, dev) -> dict:
    """The rebalance leg, skew_matrix_microbench's adaptive program at its
    sizes: the runner selection; row-mode parity at parity_events of the
    rebalanced mesh job, the one-card job and the numpy model (zipf); the
    static table's meshLoadSkew (a JobRuntime run of the zipf job at a
    quarter of the records, rebalance off, as the bench takes it); the
    adaptive uniform and zipf jobs (columnar, device stats on, rebalance
    on) with their tuples/s, rebalances, table version, recoveries, routing
    block and post-rebalance skew. Keeps the first full dispatch under the
    rebalanced table of the zipf run (`routed`)."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.metrics.registry import metrics_snapshot
    from flink_tpu_torch.runtime.executor import JobRuntime, build_runners
    from flink_tpu_torch.testing import stream as st

    n_sh, n = sz["shards"], sz["events"]
    env, _sink = control_job(sz["batch"], sz, skewed=True, shards=n_sh, rebalance=True, dev=dev)
    runners, _feeds = build_runners(plan(env._sinks), env.config, dev)
    chain = [r for r in runners if type(r).__name__ == "DeviceChainRunner"]
    op = chain[0].op if chain else None
    out = {"fused_selected": bool(chain),
           "sharded_selected": op is not None and op.mesh_devices() == n_sh,
           "local_combine_active": op is not None and bool(op.pipe.local_combine),
           "routing_table": op is not None and op.routing_version() == 0}
    del env, runners, chain, op
    ok = all(out[k] for k in ("fused_selected", "sharded_selected", "local_combine_active",
                              "routing_table"))
    # parity, row mode
    npar = sz["parity_events"]
    model = mesh_model(npar, sz, True, control_perm(sz), _t_filter_all)
    env, sink = control_job(npar, sz, skewed=True, columnar=False, dev=dev)
    card = ckpt_run(env, dev, name="skew-card")
    card_fired, card_twice = timed_fired(sink.results, sz["keys"], twice=True)
    env, sink = control_job(npar, sz, skewed=True, shards=n_sh, rebalance=True, columnar=False,
                            dev=dev)
    mesh = ckpt_run(env, dev, name="skew-adaptive-parity")
    mesh_fired, mesh_twice = timed_fired(sink.results, sz["keys"], twice=True)
    par_model, checked = st.parity(model, mesh_fired)
    out["parity"] = {
        "events": npar, "windows_checked": checked,
        "mesh_equals_card": _fired_equal(mesh_fired, card_fired),
        "mesh_equals_model": par_model, "card_equals_model": st.parity(model, card_fired)[0],
        "no_window_twice": not (card_twice or mesh_twice),
        "rebalances": mesh["client"].mesh_rebalances, "k1_card": card["k1_launches"],
        "k1_partials_mesh": mesh["k1_partials"], "status": mesh["client"].status().value}
    p = out["parity"]
    ok = ok and (p["mesh_equals_card"] and p["mesh_equals_model"] and p["card_equals_model"]
                 and p["no_window_twice"] and p["status"] == "FINISHED" and p["k1_card"] > 0
                 and p["k1_partials_mesh"] > 0)
    del env, sink, card, mesh, mesh_fired, card_fired
    # the static table's skew
    env, _sink = control_job(max(n // 4, sz["batch"] * 8), sz, skewed=True, shards=n_sh,
                             combine=False, stats=True, dev=dev)
    rt = JobRuntime(plan(env._sinks), env.config, dev)
    rt.run()
    out["static_mesh_load_skew"] = mesh_load_skew(rt)
    del env, rt
    # the adaptive legs: uniform, then zipf with K1's routed dispatch kept
    adaptive, routed = {}, ShardScanTap(take_T=sz["superbatch_steps"])
    for label, skewed in (("uniform", False), ("zipf", True)):
        env, _sink = control_job(n, sz, skewed=skewed, shards=n_sh, rebalance=True, stats=True,
                                 dev=dev)
        if skewed:
            with routed:
                r = ckpt_run(env, dev, name="skew-adaptive")
        else:
            r = ckpt_run(env, dev, name="uniform-adaptive")
        client = r["client"]
        snap = metrics_snapshot(client.metrics.all_metrics())
        blocks = [e["routing"] for e in client._runtime.device_snapshot()["operators"].values()
                  if e.get("routing")]
        adaptive[label] = {
            "seconds": r["seconds"], "tuples_per_s": n / r["seconds"],
            "status": client.status().value, "rebalances": client.mesh_rebalances,
            "gauge_mesh_rebalances": snap.get("job.meshRebalances"),
            "gauge_routing_table_version": snap.get("job.routingTableVersion"),
            "last_rebalance_ms": snap.get("job.lastRebalanceDurationMs"),
            "num_restarts": client.num_restarts,
            "recovery_kinds": [x["kind"] for x in client.exceptions.payload()["recoveries"]],
            "routing": ({k: blocks[0][k] for k in ("version", "numKeyGroups", "movedGroups")}
                        if blocks else None),
            "mesh_load_skew": mesh_load_skew(client._runtime),
            "k1": r["k1_launches"], "k1_partials": r["k1_partials"],
            "decisions": [{k: d[k] for k in ("action", "skew_before", "skew_after",
                                             "moved_groups")}
                          for d in client.rebalancer.payload()["decisions"][-4:]]}
        if skewed:
            out["assignment"] = blocks[0]["assignment"] if blocks else None
            out["_runtime"] = client._runtime
        del env, r, client
    # the rebalancer's per-step poll at interval 0 reads the per-key loads
    # back from the device on every step boundary: the uniform adaptive job
    # with the rebalancer on against off (never rebalancing under uniform
    # keys), interleaved off, on, on, off
    poll = {"on": [], "off": []}
    for side in ("off", "on", "on", "off"):
        env, _sink = control_job(n, sz, shards=n_sh, rebalance=side == "on", stats=True,
                                 dev=dev)
        r = ckpt_run(env, dev, name=f"uniform-rebalance-{side}")
        poll[side].append(r["seconds"])
        del env, r
    steps = n // sz["batch"]
    out["rebalance_poll"] = {
        "seconds": poll, "steps": steps,
        "on_over_off": min(poll["on"]) / min(poll["off"]),
        "ms_per_step": (min(poll["on"]) - min(poll["off"])) * 1000.0 / steps}
    z = adaptive["zipf"]
    out["adaptive"] = adaptive
    out["post_rebalance_mesh_load_skew"] = z["mesh_load_skew"]
    out["zipf_over_uniform"] = z["tuples_per_s"] / adaptive["uniform"]["tuples_per_s"]
    out["note"] = ("four shards time-share one card: the rebalance can show parity and "
                   "placement, not a balance gain in tuples/s")
    ok = ok and (z["status"] == "FINISHED" and z["gauge_mesh_rebalances"] >= 1
                 and z["gauge_routing_table_version"] >= 1 and z["num_restarts"] == 0
                 and "rebalance" in z["recovery_kinds"] and z["routing"] is not None
                 and z["routing"]["movedGroups"] > 0 and z["k1_partials"] > 0
                 and out["static_mesh_load_skew"] is not None
                 and z["mesh_load_skew"] is not None
                 and z["mesh_load_skew"] < out["static_mesh_load_skew"]
                 and adaptive["uniform"]["status"] == "FINISHED"
                 and adaptive["uniform"]["k1_partials"] > 0 and routed.taken is not None)
    out["routed"] = routed
    out["ok"] = bool(ok)
    return out


def _gate(at: int):
    """A source hook that blocks the source at record `at` until `go`."""
    import threading

    reached, go, fired = threading.Event(), threading.Event(), []

    def hook(idx):
        if not fired and idx[0] >= at:
            fired.append(True)
            reached.set()
            go.wait(600)
    return hook, reached, go


def control_reference(sz, dev) -> dict:
    """The uniform program on one card, columnar, at `events` records, and
    the numpy model: legs B and C compare their rows with it."""
    from flink_tpu_torch.testing import stream as st

    env, sink = control_job(sz["events"], sz, dev=dev)
    r = ckpt_run(env, dev, name="uniform-card")
    fired, twice = columnar_fired(sink.results, sz["keys"])
    par, checked = st.parity(mesh_model(sz["events"], sz, False, filt=_t_filter_all), fired)
    return {"fired": fired, "seconds": r["seconds"], "k1": r["k1_launches"],
            "equals_model": par and not twice, "windows_checked": checked}


def control_leg_b(sz, dev, ref) -> dict:
    """The autoscaler leg: the uniform program on 4 shards with
    autoscaler.enabled and parallel.mesh.autoscale, the source held at
    gate_at records while the drill runs on the coordinator's executor: a
    same-size target rejected, 4 -> 2 accepted; the job ends on 2 shards
    with the one-card job's rows. No local combine: K1's keyed (lane) entry
    runs on every shard before and after the rescale."""
    from flink_tpu_torch.metrics.registry import metrics_snapshot

    hook, reached, go = _gate(sz["gate_at"])
    env, sink = control_job(sz["events"], sz, shards=sz["shards"], combine=False, hook=hook,
                            dev=dev, conf={"autoscaler.enabled": True, "parallel.mesh.autoscale": True,
                                           "autoscaler.interval-ms": 1})
    drill = {}

    def hold(client):
        try:
            reached.wait(600)
            auto = client.autoscaler
            drill["real_executor"] = auto is not None and auto.rescale_executor is not None
            drill["same_size"] = auto.rescale_executor(client.job_id, sz["shards"], "drill")
            drill["down"] = auto.rescale_executor(client.job_id, sz["shards"] // 2, "drill")
        finally:
            go.set()

    r = ckpt_run(env, dev, name="mesh-autoscale", hold=hold)
    client = r["client"]
    fired, twice = columnar_fired(sink.results, sz["keys"])
    snap = metrics_snapshot(client.metrics.all_metrics())
    auto = client.autoscaler
    payload = auto.payload(client.job_id, num_rescales=client.mesh_rescales,
                           last_rescale_duration_ms=client.last_mesh_rescale_duration_ms)
    out = {"seconds": r["seconds"], "status": client.status().value, **drill,
           "mesh_rescales": client.mesh_rescales, "num_restarts": client.num_restarts,
           "mesh_devices_after": client._runtime.mesh_devices(),
           "last_rescale_ms": snap.get("job.lastRescaleDurationMs"),
           "num_rescales_gauge": snap.get("job.numRescales"),
           "samples_observed": auto._signals.estimate(client.job_id).samples,
           "payload": {k: payload[k] for k in ("enabled", "policy", "num_rescales",
                                                "last_rescale_duration_ms")},
           "recovery_kinds": [x["kind"] for x in client.exceptions.payload()["recoveries"]],
           "rows_equal_card": _fired_equal(fired, ref["fired"]) and not twice,
           "k1": r["k1_launches"], "k1_partials": r["k1_partials"]}
    out["ok"] = bool(
        out["status"] == "FINISHED" and out["real_executor"]
        and not out["same_size"][0] and f"already at {sz['shards']}" in out["same_size"][1]
        and out["down"][0] and out["mesh_rescales"] == 1 and out["num_restarts"] == 0
        and out["mesh_devices_after"] == sz["shards"] // 2 and out["last_rescale_ms"] > 0
        and out["num_rescales_gauge"] == 1 and out["payload"]["enabled"]
        and out["samples_observed"] >= 1 and out["recovery_kinds"] == ["rescale"]
        and out["rows_equal_card"] and out["k1"] > 0 and out["k1_partials"] == 0)
    return out


def control_leg_c(sz, dev, ref) -> dict:
    """The device-loss degrade: leg B's job without the autoscaler, with
    checkpoints every checkpoint_ms and parallel.mesh.degrade-on-device-loss;
    a RuntimeError carrying the device-scoped chaos marker is raised at the
    fail_at-th sharded dispatch by a ShardScanTap installed for this run.
    One restart, 4 -> 2 shards, from a restored checkpoint, the one-card
    rows; K1's keyed (lane) entry on every shard, as in leg B."""
    env, sink = control_job(sz["events"], sz, shards=sz["shards"], combine=False, dev=dev,
                            conf={"execution.checkpointing.interval": sz["checkpoint_ms"],
                                  "parallel.mesh.degrade-on-device-loss": True})
    with ShardScanTap(fail_at=sz["fail_at"]) as tap:
        r = ckpt_run(env, dev, name="mesh-device-loss")
    client = r["client"]
    fired, twice = columnar_fired(sink.results, sz["keys"])
    history = client.exceptions.payload()
    out = {"seconds": r["seconds"], "status": client.status().value,
           "dispatches": tap.calls, "num_restarts": client.num_restarts,
           "num_checkpoints": client.num_checkpoints,
           "mesh_devices_after": client._runtime.mesh_devices(),
           "injected": [e["injected"] for e in history["entries"]],
           "restored_checkpoint_ids": [x["restored_checkpoint_id"]
                                       for x in history["recoveries"]],
           "rows_equal_card": _fired_equal(fired, ref["fired"]) and not twice,
           "k1": r["k1_launches"], "k1_partials": r["k1_partials"]}
    out["ok"] = bool(
        out["status"] == "FINISHED" and out["num_restarts"] == 1
        and out["mesh_devices_after"] == sz["shards"] // 2 and out["injected"] == [True]
        and len(out["restored_checkpoint_ids"]) == 1
        and out["restored_checkpoint_ids"][0] is not None and out["rows_equal_card"]
        and out["k1"] > 0 and out["k1_partials"] == 0 and out["dispatches"] > sz["fail_at"])
    return out


def api_mesh_control_phase(dev=DEV, sizes=None) -> dict:
    """Legs A, B and C over four shards of `dev` (visible_devices replaced
    for the phase, restored after); on the card, K1 against its plain
    version at shard 0's first full dispatch under leg A's rebalanced table
    (`k1_mesh_routed`, the partials entry) and the table swap against its
    bytes bound (`routing_swap`)."""
    from flink_tpu_torch.parallel import mesh as mesh_lib

    sz = dict(API_MESH_CONTROL, **(sizes or {}))
    card = card_line() if torch.device(dev).type == "cuda" else "cpu"
    real = mesh_lib.visible_devices
    mesh_shards(sz["shards"], dev)
    out = {"phase": "api_mesh_control", "card": card, "shards": sz["shards"],
           "shard_devices": [str(d) for d in mesh_lib.visible_devices(dev)]}
    try:
        t0 = time.perf_counter()
        leg_a = control_leg_a(sz, dev)
        routed, runtime = leg_a.pop("routed"), leg_a.pop("_runtime", None)
        out["leg_a"] = dict(leg_a, phase_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = control_reference(sz, dev)
        out["reference"] = {k: v for k, v in ref.items() if k != "fired"}
        out["leg_b"] = dict(control_leg_b(sz, dev, ref), phase_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["leg_c"] = dict(control_leg_c(sz, dev, ref), phase_s=time.perf_counter() - t0)
        del ref
        shim, agg, plan, cpart, parts = routed.k1_inputs()
        out["routed_dispatch"] = {
            "K_local": shim.K, "T": int(plan[0].shape[0]), "fires": len(plan[5]),
            "partials_shape": list(cpart.shape), "partial_records": int(cpart.sum()),
            "table_version": routed.taken[0].routing_version()}
        if torch.device(dev).type == "cuda":
            t0 = time.perf_counter()
            out["k1_mesh_routed"] = k1_partials_at(
                f"api_mesh_control leg A zipf: shard 0 of {sz['shards']}, its folded partials "
                "of the first full dispatch under the rebalanced table", shim, agg, plan, cpart,
                parts)
            out["k1_mesh_routed"]["seconds"] = time.perf_counter() - t0
            if runtime is not None and leg_a.get("assignment") is not None:
                out["routing_swap"] = routing_swap(runtime, np.asarray(leg_a["assignment"]),
                                                   sz["swap_reps"], dev)
            del shim, plan, cpart, parts
        del routed, runtime
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    finally:
        mesh_lib.visible_devices = real
    out["ok"] = bool(out["leg_a"]["ok"] and out["reference"]["equals_model"]
                     and out["leg_b"]["ok"] and out["leg_c"]["ok"])
    return out


# ---------------------------------------------------------------------------
# phase 29: api_topologies, the rest of the DataStream API on the card: a
# union of two YSB feeds into the fused chain (K1), a map_batch chain and a
# process() side output into host-keyed windows (K1), the host operators
# against numpy models, and SQL UNION ALL
# ---------------------------------------------------------------------------

# leg A: api_path_microbench's program over two feeds (the api stream's even
# and odd records), row mode at 2^21 and columnar at 2^22, best of 2; leg B:
# 2^18 records over 8192 campaigns of 10 ads, batch 16384 (4 s of event
# time a batch); leg C: 2^16 records over 1024 keys, batch 4096; leg D:
# two HOP statements over sql_path_microbench's table at 2^19 records
API_TOPOLOGIES = dict(parity_events=1 << 21, timed_events=1 << 22, warmup_events=1 << 19,
                      runs=2, b_events=1 << 18, b_batch=16_384, ads_per_campaign=10,
                      b_tumble=1_000, c_events=1 << 16, c_keys=1024, c_batch=4096,
                      async_capacity=16, async_delay_s=1e-4, cep_within=10_000,
                      max_rounds=16, d_events=1 << 19)
CLICKS = "clicks"
SQL_YSB_PURCHASES = SQL_YSB.replace("event_type < 0.5", "event_type > 1.5")


def union_job(n: int, *, columnar: bool, dev=DEV):
    """(env, sink) of the api_ysb program (fused) over `a.union(b)`, where a
    and b are two sources with the program's watermark strategy that hold
    the n-record api stream's even- and odd-numbered records."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, API["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, API["keys"])
    cfg.set(ExecutionOptions.COLUMNAR_OUTPUT, columnar)
    env = StreamExecutionEnvironment(cfg, device=dev)

    def feed(parity: int):
        def gen(idx):
            return Batch(*st.api_columns(2 * idx + parity, n, API["keys"]))
        return env.from_source(DataGeneratorSource(gen, n // 2),
                               WatermarkStrategy.for_bounded_out_of_orderness(0),
                               name=f"feed{parity}")

    sink = rows_sink()
    (feed(0).union(feed(1))
     .filter(_t_filter, traceable=True).key_by(_t_key, traceable=True)
     .window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
     .aggregate("count").sink_to(sink))
    return env, sink


def union_run(n: int, *, columnar: bool, dev=DEV):
    """One execute() of the union job with the launch counts at 0 just
    before it: (sink, seconds, K1 dispatches)."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    env, sink = union_job(n, columnar=columnar, dev=dev)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    return sink, time.perf_counter() - t0, cs.LAUNCHES["k1_superscan"]


def union_selection(dev=DEV) -> dict:
    """The runners the union job builds: the fused runner (the traceable
    filter and key, absorbed) downstream of the UnionRunner."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.executor import build_runners

    env, _sink = union_job(API_TOPOLOGIES["warmup_events"], columnar=True, dev=dev)
    runners, _feeds = build_runners(plan(env._sinks), env.config, dev)
    union = [r for r in runners if type(r).__name__ == "UnionRunner"]
    fed = [type(r).__name__ for r, _o in union[0].downstream.edges] if union else []
    return {"runners": [type(r).__name__ for r in runners], "union_feeds": fed,
            "ok": len(union) == 1 and fed == ["DeviceChainRunner"]}


def union_k1_inputs(n: int, dev=DEV):
    """K1's inputs at the union job's first full fused dispatch (T = 32),
    taken from the call the pipeline makes in a columnar run of n records:
    (pipe, agg, idx, vals, plan with one entry a planned fire)."""
    from flink_tpu_torch.graph.transformation import plan as plan_graph
    from flink_tpu_torch.runtime.executor import JobRuntime

    env, _sink = union_job(n, columnar=True, dev=dev)
    rt = JobRuntime(plan_graph(env._sinks), env.config, dev)
    with K1Tap() as tap:
        rt.run()
    if tap.taken is None or int(tap.taken[4][0].shape[0]) != 32:
        raise AssertionError("api_topologies: the union job made no full fused dispatch")
    pipe = next(r for r in rt.runners if type(r).__name__ == "DeviceChainRunner").op.pipe
    agg, _rings, idx, vals, plan5 = tap.taken
    return pipe, agg, idx, vals, K1Tap.plan(plan5)


def topo_leg_a(sz, dev) -> dict:
    """The union job against the single-source job and the numpy oracle in
    row mode, then both timed columnar, interleaved, best of sz["runs"]."""
    from flink_tpu_torch.testing import stream as st

    out = {"selection": union_selection(dev)}
    n = sz["parity_events"]
    ref = st.api_replay(n, API["batch"], num_keys=API["keys"])
    union_sink, union_s, union_k1 = union_run(n, columnar=False, dev=dev)
    single_sink, single_s, single_k1 = api_run(n, True, columnar=False, dev=dev)
    union_fired = api_fired(union_sink, API["window"], API["slide"])
    single_fired = api_fired(single_sink, API["window"], API["slide"])
    oracle_ok, checked = st.parity(ref.fired, union_fired)
    same = (set(union_fired) == set(single_fired)
            and all(np.array_equal(union_fired[j], single_fired[j]) for j in union_fired))
    out["parity"] = {"events": n, "union_equals_single": same, "union_equals_oracle": oracle_ok,
                     "windows_checked": checked, "union_k1": union_k1, "single_k1": single_k1,
                     "union_s": union_s, "single_s": single_s}
    del union_sink, single_sink, union_fired, single_fired
    n = sz["timed_events"]
    union_run(sz["warmup_events"], columnar=True, dev=dev)
    api_run(sz["warmup_events"], True, columnar=True, dev=dev)
    runs = {"union": [], "single": []}
    for _ in range(sz["runs"]):
        for name in ("union", "single"):
            run = (union_run(n, columnar=True, dev=dev) if name == "union"
                   else api_run(n, True, columnar=True, dev=dev))
            runs[name].append({"seconds": run[1], "k1_launches": run[2]})
    timed = {name: {"events": n, "tuples_per_s": n / min(r["seconds"] for r in rs),
                    "all_seconds": [r["seconds"] for r in rs],
                    "k1_launches": [r["k1_launches"] for r in rs]}
             for name, rs in runs.items()}
    timed["union_over_single"] = (timed["union"]["tuples_per_s"]
                                  / timed["single"]["tuples_per_s"])
    out["timed"] = timed
    launched = (out["parity"]["union_k1"] > 0 and out["parity"]["single_k1"] > 0
                and all(k > 0 for r in runs.values() for k in (x["k1_launches"] for x in r)))
    out["ok"] = bool(out["selection"]["ok"] and same and oracle_ok and launched)
    return out


def _window_model(keys, ts, vals, window_ms: int, slide_ms: int, num_keys: int) -> dict:
    """{window index: row over the keys} of a sum (vals) or count (vals
    None) over every window that holds a record: the rows in-order records
    give once the final watermark has fired every window."""
    spw = window_ms // slide_ms
    s = ts // slide_ms
    j = (s[:, None] - np.arange(spw)[None, :]).reshape(-1)
    k = np.repeat(keys, spw)
    v = np.ones(len(j)) if vals is None else np.repeat(vals.astype(np.float64), spw)
    j0 = int(j.min())
    grid = np.zeros((int(j.max()) - j0 + 1, num_keys))
    np.add.at(grid, (j - j0, k), v)
    seen = np.zeros_like(grid, dtype=bool)
    seen[j - j0, k] = True
    return {j0 + i: grid[i] for i in range(len(grid)) if seen[i].any()}


def _fired_rows(batches, window_ms: int, slide_ms: int, num_keys: int) -> dict:
    """Row-mode (key, value) sink batches as {window index: row}."""
    fired = {}
    for values, ts in batches:
        for (k, v), t in zip(values, ts):
            row = fired.setdefault((int(t) + 1 - window_ms) // slide_ms, np.zeros(num_keys))
            row[int(k)] = v
    return fired


def _fired_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[j], b[j]) for j in a)


def topo_b_job(sz, dev=DEV):
    """(env, sums sink, clicks sink, ad -> campaign table): a map_batch that
    joins each batch's ad ids to their campaigns with one lookup feeds a 1 s
    tumbling sum of the payload per campaign (host key dictionary, K1's add
    field); a keyed process() routes the clicks (event type 1) to a side
    output, which feeds a 10 s / 1 s sliding count per campaign."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import OutputTag, ProcessFunction
    from flink_tpu_torch.api.windowing.assigners import (
        SlidingEventTimeWindows,
        TumblingEventTimeWindows,
    )
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["b_events"], API["keys"]
    ads = keys * sz["ads_per_campaign"]
    table = np.random.default_rng(18).permutation(ads) % keys
    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": sz["b_batch"], "execution.state.key-capacity": keys}),
        device=dev)

    def gen(idx):
        return Batch(*st.api_columns(idx, n, ads, payload=True))

    def enrich(records):
        # one lookup over the whole batch: (campaign, event type, payload)
        cols = np.stack(records)
        camp = table[cols[:, 0].astype(np.int64)]
        return list(zip(camp.tolist(), cols[:, 1].astype(np.int64).tolist(),
                        cols[:, 2].astype(np.int64).tolist()))

    class RouteClicks(ProcessFunction):
        def process_element(self, value, ctx):
            if value[1] == 1:
                ctx.output(OutputTag(CLICKS), value)
            return ()

    events = (env.from_source(DataGeneratorSource(gen, n),
                              WatermarkStrategy.for_bounded_out_of_orderness(0))
              .map_batch(enrich, name="campaign_lookup"))
    sums, clicks = rows_sink(), rows_sink()
    (events.key_by(lambda r: r[0])
     .window(TumblingEventTimeWindows.of(sz["b_tumble"])).sum(lambda r: r[2]).sink_to(sums))
    (events.key_by(lambda r: r[0]).process(RouteClicks(), name="route_clicks")
     .get_side_output(OutputTag(CLICKS)).key_by(lambda r: r[0])
     .window(SlidingEventTimeWindows.of(API["window"], API["slide"])).count().sink_to(clicks))
    return env, sums, clicks, table


def topo_leg_b(sz, dev) -> dict:
    """Leg B's job against numpy: both sinks window by window, and the
    runners it selects (host-keyed window runners on K1)."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["b_events"], API["keys"]
    env, sums, clicks, table = topo_b_job(sz, dev)
    runners, _f = build_runners(plan(env._sinks), env.config, dev)
    kinds = sorted(type(r).__name__ for r in runners)
    ops = sorted(type(r.op).__name__ for r in runners if type(r).__name__ == "WindowStepRunner")
    env, sums, clicks, table = topo_b_job(sz, dev)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    secs, k1 = time.perf_counter() - t0, cs.LAUNCHES["k1_superscan"]
    col, ts = st.api_columns(np.arange(n, dtype=np.int64), n, keys * sz["ads_per_campaign"],
                             payload=True)
    camp = table[col[:, 0].astype(np.int64)]
    click = col[:, 1] == 1
    sums_ok = _fired_equal(_fired_rows(sums.batches, sz["b_tumble"], sz["b_tumble"], keys),
                           _window_model(camp, ts, col[:, 2], sz["b_tumble"], sz["b_tumble"],
                                         keys))
    clicks_ok = _fired_equal(_fired_rows(clicks.batches, API["window"], API["slide"], keys),
                             _window_model(camp[click], ts[click], None, API["window"],
                                           API["slide"], keys))
    out = {"events": n, "runners": kinds, "window_operators": ops, "seconds": secs,
           "tuples_per_s": n / secs, "k1_launches": k1, "sums_equal_numpy": sums_ok,
           "clicks_equal_numpy": clicks_ok,
           "side_rows": sum(len(v) for v, _t in clicks.batches)}
    out["ok"] = bool(sums_ok and clicks_ok and k1 > 0
                     and ops == ["FusedWindowOperator", "FusedWindowOperator"]
                     and "KeyedProcessRunner" in kinds)
    return out


def topo_c_env(sz, dev=DEV, *, batch=None, hook=None, conf=None):
    """(env, stream, columns) of leg C: the api stream's records at
    sz["c_events"] over sz["c_keys"] keys as (key, event type, payload,
    ts) tuples, in order, with the program's watermark strategy."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.utils.arrays import obj_array

    n, keys = sz["c_events"], sz["c_keys"]
    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": batch or sz["c_batch"], **(conf or {})}), device=dev)

    def gen(idx):
        if hook is not None:
            hook(idx)
        col, ts = st.api_columns(idx, n, keys, payload=True)
        c = col.astype(np.int64)
        return Batch(obj_array(list(zip(c[:, 0].tolist(), c[:, 1].tolist(), c[:, 2].tolist(),
                                        ts.tolist()))), ts)

    stream = env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
    col, ts = st.api_columns(np.arange(n, dtype=np.int64), n, keys, payload=True)
    c = col.astype(np.int64)
    return env, stream, (c[:, 0], c[:, 1], c[:, 2], ts)


def topo_timed(name: str, env, sink, dev=DEV) -> dict:
    """One execute(): its seconds and rows."""
    _sync(dev)
    t0 = time.perf_counter()
    env.execute(name)
    _sync(dev)
    return {"seconds": time.perf_counter() - t0, "rows": list(sink.results)}


def topo_reduce(sz, dev) -> dict:
    """Keyed reduce (a running payload sum) through execute_async, its
    source held at half the records while query_state reads 16 keys' running
    values; then the rows against the running sums in record order."""
    n = sz["c_events"]
    hook, reached, go = _gate(n // 2)
    env, stream, (k, _e, p, ts) = topo_c_env(sz, dev, hook=hook)
    sink = stream.map(lambda r: (r[0], r[2])).key_by(lambda r: r[0]).reduce(
        lambda a, b: (a[0], a[1] + b[1]), name="running_sum").collect()
    client = env.execute_async("topologies-reduce")
    try:
        if not reached.wait(120):
            raise AssertionError("api_topologies: the reduce job's source never reached its gate")
        probe = [int(x) for x in k[:16]]
        uid = next(r.uid for r in client._runtime.runners
                   if type(r).__name__ == "KeyedReduceRunner")
        views = {key: client.query_state(uid, key)["value"] for key in probe}
    finally:
        go.set()
    client.wait(300)
    run = np.zeros(sz["c_keys"], dtype=np.int64)
    want, at_gate = [], {}
    for i, (key, pay) in enumerate(zip(k.tolist(), p.tolist())):
        if i == n // 2:
            at_gate = {q: (q, int(run[q])) for q in probe}
        run[key] += pay
        want.append((key, int(run[key])))
    got = [(int(a), int(b)) for a, b in sink.results]
    return {"rows": len(got), "rows_equal_model": got == want,
            "query_state_equal_model": views == at_gate,
            "ok": got == want and views == at_gate and client.status().value == "FINISHED"}


def topo_connect(sz, dev) -> dict:
    """Impressions (event type 0) and clicks (1) of the stream, connected
    and keyed by campaign: both inputs share the key's impression count, a
    click reads it, and an event-time timer at the end of each second with
    an impression emits the key's counts there."""
    from flink_tpu_torch.api.functions import ProcessFunction

    class Attribute(ProcessFunction):
        def process_element1(self, v, ctx):
            st_ = ctx.timer_service.state()
            st_.put("imps", (st_.get("imps") or 0) + 1)
            ctx.timer_service.register_event_time_timer(v[3] - v[3] % 1000 + 999)
            return ()

        def process_element2(self, v, ctx):
            st_ = ctx.timer_service.state()
            st_.put("clicks", (st_.get("clicks") or 0) + 1)
            return [("click", v[0], v[3], st_.get("imps") or 0)]

        def on_timer(self, t, ctx):
            st_ = ctx.timer_service.state()
            return [("second", t, st_.get("imps") or 0, st_.get("clicks") or 0)]

    env, stream, (k, e, _p, ts) = topo_c_env(sz, dev)
    imps = stream.filter(lambda r: r[1] == 0)
    clicks = stream.filter(lambda r: r[1] == 1)
    sink = (imps.connect(clicks).key_by(lambda r: r[0], lambda r: r[0])
            .process(Attribute()).collect())
    run = topo_timed("topologies-connect", env, sink, dev)
    # the model: a batch's impressions reach the operator before its clicks
    # (the two chains in plan order); the timers fire at the batch's
    # watermark, each reading its key's counts then
    b, keys = sz["c_batch"], sz["c_keys"]
    imp_n, clk_n = np.zeros(keys, np.int64), np.zeros(keys, np.int64)
    timers, want = set(), []
    for lo in range(0, len(k), b):
        sl = slice(lo, lo + b)
        for key, t in zip(k[sl][e[sl] == 0].tolist(), ts[sl][e[sl] == 0].tolist()):
            imp_n[key] += 1
            timers.add((t - t % 1000 + 999, key))
        for key, t in zip(k[sl][e[sl] == 1].tolist(), ts[sl][e[sl] == 1].tolist()):
            clk_n[key] += 1
            want.append(("click", key, t, int(imp_n[key])))
        wm = int(ts[sl].max()) - 1
        for t, key in sorted(x for x in timers if x[0] <= wm):
            want.append(("second", t, int(imp_n[key]), int(clk_n[key])))
        timers = {x for x in timers if x[0] > wm}
    for t, key in sorted(timers):
        want.append(("second", t, int(imp_n[key]), int(clk_n[key])))
    got = sorted(tuple(int(x) if not isinstance(x, str) else x for x in r) for r in run["rows"])
    ok = got == sorted(want)
    return {"rows": len(got), "rows_equal_model": ok, "seconds": run["seconds"], "ok": ok}


def topo_broadcast(sz, dev) -> dict:
    """The broadcast state pattern: 8 rules (a key modulus and a least
    payload) broadcast to every event; an event emits the rules it meets.
    The rules' source takes its first turn after the events' first batch,
    so that batch meets no rule."""
    from flink_tpu_torch.core.watermarks import WatermarkStrategy

    rules = [(i, m, lo) for i, (m, lo) in enumerate(
        [(2, 9), (3, 8), (5, 5), (7, 3), (11, 0), (13, 10), (17, 6), (19, 2)])]

    class Rules:
        def process_element(self, v, state):
            hit = [rid for rid, (m, lo) in sorted(state.items()) if v[0] % m == 0 and v[2] >= lo]
            return [(v[0], v[3], tuple(hit))] if hit else []

        def process_broadcast_element(self, rule, state):
            state[rule[0]] = (rule[1], rule[2])

    env, stream, (k, _e, p, ts) = topo_c_env(sz, dev)
    rule_stream = env.from_collection(rules, timestamp_fn=lambda r: 0,
                                      watermark_strategy=WatermarkStrategy
                                      .for_bounded_out_of_orderness(0)).broadcast()
    sink = stream.connect(rule_stream).process(Rules()).collect()
    run = topo_timed("topologies-broadcast", env, sink, dev)
    want = []
    for i, (key, pay, t) in enumerate(zip(k.tolist(), p.tolist(), ts.tolist())):
        if i < sz["c_batch"]:
            continue
        hit = tuple(rid for rid, m, lo in rules if key % m == 0 and pay >= lo)
        if hit:
            want.append((key, t, hit))
    got = [(int(a), int(b), tuple(c)) for a, b, c in run["rows"]]
    ok = got == want
    return {"rows": len(got), "rows_equal_model": ok, "seconds": run["seconds"], "ok": ok}


def topo_iterate(sz, dev) -> dict:
    """A decrement loop: each record (key, payload) goes round until its
    count reaches 0, then leaves by the loop exit with its rounds; and a
    loop with max_rounds below the deepest record raises."""
    def job(max_rounds):
        env, stream, cols = topo_c_env(sz, dev)
        it = stream.map(lambda r: (r[0], r[2], 0)).iterate(max_rounds=max_rounds)
        body = it.map(lambda r: (r[0], r[1] - 1, r[2] + 1))
        it.close_with(body.filter(lambda r: r[1] > 0))
        return env, body.filter(lambda r: r[1] <= 0).collect(), cols

    env, sink, (k, _e, p, _ts) = job(sz["max_rounds"])
    run = topo_timed("topologies-iterate", env, sink, dev)
    want = sorted((key, min(pay, 1) - 1, max(pay, 1)) for key, pay in zip(k.tolist(), p.tolist()))
    got = sorted((int(a), int(b), int(c)) for a, b, c in run["rows"])
    # the deepest record needs p.max() - 1 feedback rounds
    env, _sink, _cols = job(int(p.max()) - 2)
    try:
        env.execute("topologies-iterate-bounded")
        guard = False
    except RuntimeError as e:
        guard = "max_rounds" in str(e)
    ok = got == want and guard
    return {"rows": len(got), "rows_equal_model": got == want, "max_rounds_guard": guard,
            "seconds": run["seconds"], "ok": ok}


def topo_async(sz, dev) -> dict:
    """async_map over a local function that sleeps sz["async_delay_s"] a
    record, capacity sz["async_capacity"], ordered (the rows in input order)
    and unordered (the same rows as a multiset)."""
    def lookup(r):
        time.sleep(sz["async_delay_s"])
        return (r[0], r[2] * 2, r[3])

    out = {}
    for mode, ordered in (("ordered", True), ("unordered", False)):
        env, stream, (k, _e, p, ts) = topo_c_env(sz, dev)
        sink = stream.async_map(lookup, capacity=sz["async_capacity"], ordered=ordered).collect()
        run = topo_timed(f"topologies-async-{mode}", env, sink, dev)
        want = list(zip(k.tolist(), (2 * p).tolist(), ts.tolist()))
        got = [tuple(int(x) for x in r) for r in run["rows"]]
        same = got == want if ordered else sorted(got) == sorted(want)
        out[mode] = {"rows": len(got), "rows_equal_model": same, "seconds": run["seconds"],
                     "tuples_per_s": len(got) / run["seconds"]}
    out["ok"] = all(out[m]["rows_equal_model"] for m in ("ordered", "unordered"))
    return out


def topo_cep(sz, dev) -> dict:
    """CEP per key: an impression strictly followed by a click within
    sz["cep_within"] ms; a match per such adjacent pair of the key's
    events."""
    from flink_tpu_torch.cep import Pattern, pattern_stream

    pattern = (Pattern.begin("imp").where(lambda r: r[1] == 0)
               .next("click").where(lambda r: r[1] == 1).within(sz["cep_within"]))
    env, stream, (k, e, _p, ts) = topo_c_env(sz, dev)
    sink = pattern_stream(stream.key_by(lambda r: r[0]), pattern, select_fn=lambda m: (
        m["imp"][0][0], m["imp"][0][3], m["click"][0][3])).collect()
    run = topo_timed("topologies-cep", env, sink, dev)
    last = {}
    want = []
    for key, ev, t in zip(k.tolist(), e.tolist(), ts.tolist()):
        prev = last.get(key)
        if prev is not None and prev[0] == 0 and ev == 1 and t - prev[1] <= sz["cep_within"]:
            want.append((key, prev[1], t))
        last[key] = (ev, t)
    got = sorted(tuple(int(x) for x in r) for r in run["rows"])
    ok = got == sorted(want) and len(got) > 0
    return {"rows": len(got), "rows_equal_model": ok, "seconds": run["seconds"], "ok": ok}


def topo_v2(sz, dev) -> dict:
    """An API V2 job: a keyed process that emits (key, 3 x payload) for
    each purchase (event type 2), in record order."""
    from flink_tpu_torch.api.v2 import (
        ExecutionEnvironment,
        NonKeyedPartitionStream,
        OneInputStreamProcessFunction,
    )

    class Purchases(OneInputStreamProcessFunction):
        def process_record(self, record, output, ctx):
            if record[1] == 2:
                output.collect((ctx.key, 3 * record[2]))

    env, stream, (k, e, p, _ts) = topo_c_env(sz, dev)
    v2 = ExecutionEnvironment(env)
    sink = (NonKeyedPartitionStream(stream).key_by(lambda r: r[0]).process(Purchases())
            .collect_to_list())
    t0 = time.perf_counter()
    v2.execute("topologies-v2")
    want = [(key, 3 * pay) for key, ev, pay in zip(k.tolist(), e.tolist(), p.tolist()) if ev == 2]
    got = [(int(a), int(b)) for a, b in sink.results]
    return {"rows": len(got), "rows_equal_model": got == want,
            "seconds": time.perf_counter() - t0, "ok": got == want}


def topo_coordinator(sz, dev, tmp: str) -> dict:
    """A keyed process whose function declares create_coordinator(): each
    record sends its key up, the coordinator counts and answers with its
    count, which the record carries out. Checkpoints every step and one
    host failure in the source at 60% of the records: one restart, the rows
    equal the uninterrupted run's, and the coordinator's count ends at the
    number of records (restored with the checkpoint, not recounted)."""
    from flink_tpu_torch.runtime.coordination import OperatorCoordinator

    class Counter(OperatorCoordinator):
        def __init__(self):
            self.seen = 0

        def start(self, context):
            self.ctx = context

        def handle_event(self, event):
            self.seen += 1
            self.ctx.send_to_operator(self.seen)

        def checkpoint(self):
            return {"seen": self.seen}

        def restore(self, snap):
            self.seen = snap["seen"]

    class Stamped:
        last = None

        def create_coordinator(self):
            return Counter()

        def handle_coordinator_event(self, event):
            self.last = event

        def process_element(self, v, ctx):
            self.coordinator_gateway.send_event(v[0])
            return [(v[0], v[3], self.last)]

    n = sz["c_events"]
    out = {}
    for name, fail in (("uninterrupted", False), ("failure", True)):
        failed = []

        def hook(idx, failed=failed, fail=fail):
            if fail and not failed and idx[0] >= int(0.6 * n):
                failed.append(True)
                raise RuntimeError("injected host failure in the source")

        fn = Stamped()
        env, stream, _cols = topo_c_env(sz, dev, hook=hook, conf={
            "execution.checkpointing.interval": 1,
            "execution.checkpointing.dir": f"{tmp}/coordinator-{name}",
            "restart-strategy.type": "fixed-delay", "restart-strategy.initial-backoff": 1})
        sink = stream.key_by(lambda r: r[0]).process(fn, name="stamped").collect()
        rec = ckpt_run(env, dev, timeout=300, name=f"topologies-coordinator-{name}")
        client = rec["client"]
        out[name] = {"status": client.status().value, "seconds": rec["seconds"],
                     **ckpt_stats(client), "rows": list(sink.results),
                     "coordinator_seen": fn._operator_coordinator.seen}
    a, b = out["uninterrupted"], out["failure"]
    rows_equal = a.pop("rows") == b.pop("rows")
    out["rows_equal"] = rows_equal
    out["ok"] = bool(rows_equal and a["status"] == b["status"] == "FINISHED"
                     and a["num_restarts"] == 0 and b["num_restarts"] == 1
                     and b["restored_checkpoint_id"] is not None
                     and a["coordinator_seen"] == b["coordinator_seen"] == n)
    return out


def topo_leg_c(sz, dev, tmp: str) -> dict:
    out = {}
    for name, run in (("reduce", topo_reduce), ("connect", topo_connect),
                      ("broadcast", topo_broadcast), ("iterate", topo_iterate),
                      ("async", topo_async), ("cep", topo_cep), ("v2", topo_v2)):
        t0 = time.perf_counter()
        out[name] = dict(run(sz, dev), phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["coordinator"] = dict(topo_coordinator(sz, dev, tmp), phase_s=time.perf_counter() - t0)
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def union_all_job(n: int, statements, dev=DEV):
    """(env, tenv, sink) of `statements` joined by UNION ALL over the
    columnar `ysb` table of n records (sql_ysb_job's table)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration, ExecutionOptions
    from flink_tpu_torch.connectors.source import Batch, DataGeneratorSource
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.table import TableEnvironment, TableSchema
    from flink_tpu_torch.testing import stream as st

    def gen(idx):
        return Batch(*st.api_columns(idx, n, API_SQL["keys"]))

    cfg = Configuration()
    cfg.set(ExecutionOptions.BATCH_SIZE, API_SQL["batch"])
    cfg.set(ExecutionOptions.KEY_CAPACITY, API_SQL["keys"])
    env = StreamExecutionEnvironment(cfg, device=dev)
    tenv = TableEnvironment(env)
    stream = env.from_source(DataGeneratorSource(gen, n),
                             WatermarkStrategy.for_bounded_out_of_orderness(0))
    tenv.register_table("ysb", stream,
                        TableSchema(["campaign", "event_type", "rowtime"], rowtime="rowtime",
                                    field_types=["int", "float", "int"]), columnar=True)
    sink = tenv.sql_query(" UNION ALL ".join(statements)).collect()
    return env, tenv, sink


# the JAX package's plan report of the UNION ALL statement
UNION_ALL_REPORT = ("interpreted", "union", "UNION ALL branches plan independently on the host")


def topo_leg_d(sz, dev) -> dict:
    """SQL UNION ALL of the YSB views statement and its purchases twin:
    rows equal each statement run alone, united, and the numpy model; each
    branch a window runner on K1; the plan report the JAX package's."""
    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.executor import build_runners
    from flink_tpu_torch.testing import stream as st

    n, keys = sz["d_events"], API_SQL["keys"]
    both = (SQL_YSB, SQL_YSB_PURCHASES)
    env, tenv, sink = union_all_job(n, both, dev)
    rep = tenv.last_plan_report
    report = (rep.path, rep.reason, rep.detail)
    runners, _f = build_runners(plan(env._sinks), env.config, dev)
    kinds = [type(r).__name__ for r in runners]
    window_ops = [type(r.op).__name__ for r in runners if hasattr(r, "op")]
    env, tenv, sink = union_all_job(n, both, dev)
    secs, k1 = sql_counted(env, dev)
    alone = []
    for q in both:
        e1, _t1, s1 = union_all_job(n, (q,), dev)
        sql_counted(e1, dev)
        alone += s1.results
    key = lambda r: (r["wend"], r["campaign"], r["views"])  # noqa: E731
    got = sorted(map(key, sink.results))
    col, ts = st.api_columns(np.arange(n, dtype=np.int64), n, keys)
    model = []
    for keep in (col[:, 1] < 0.5, col[:, 1] > 1.5):
        fired = _window_model(col[keep, 0].astype(np.int64), ts[keep], None,
                              API_SQL["window"], API_SQL["slide"], keys)
        for j, row in fired.items():
            wend = j * API_SQL["slide"] + API_SQL["window"]
            model += [(wend, int(c), int(row[c])) for c in np.flatnonzero(row)]
    out = {"events": n, "report": list(report), "report_equals_jax": report == UNION_ALL_REPORT,
           "runners": kinds, "window_operators": window_ops, "seconds": secs,
           "tuples_per_s": n / secs, "k1_launches": k1, "rows": len(got),
           "equals_branches_alone": got == sorted(map(key, alone)),
           "equals_model": got == sorted(model)}
    out["ok"] = bool(out["report_equals_jax"] and out["equals_branches_alone"]
                     and out["equals_model"] and k1 > 0 and kinds.count("UnionRunner") == 1
                     and window_ops.count("FusedWindowOperator") == 2)
    return out


def api_topologies_phase(dev=DEV, sizes=None) -> dict:
    """Legs A-D (see API_TOPOLOGIES); on the card, K1 against its plain
    version at leg A's first full union dispatch (`k1_union`)."""
    import tempfile

    sz = dict(API_TOPOLOGIES, **(sizes or {}))
    out = {"phase": "api_topologies",
           "card": card_line() if torch.device(dev).type == "cuda" else "cpu"}
    for name, leg in (("leg_a", topo_leg_a), ("leg_b", topo_leg_b)):
        t0 = time.perf_counter()
        out[name] = dict(leg(sz, dev), phase_s=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["leg_c"] = dict(topo_leg_c(sz, dev, tmp), phase_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    out["leg_d"] = dict(topo_leg_d(sz, dev), phase_s=time.perf_counter() - t0)
    if torch.device(dev).type == "cuda":
        t0 = time.perf_counter()
        pipe, agg, idx, vals, plan = union_k1_inputs(sz["timed_events"], dev)
        out["k1_union"] = dict(k1_at_dispatch(
            "api_topologies leg A: a.union(b) of the api stream's even and odd records, "
            "count, first full dispatch", pipe, agg, idx, vals, plan),
            seconds=time.perf_counter() - t0)
    out["ok"] = all(out[leg]["ok"] for leg in ("leg_a", "leg_b", "leg_c", "leg_d"))
    return out


# ---------------------------------------------------------------------------
# phase 30: api_chaos, the chaos plane's drills on the card: the eight
# in-process scenarios of chaos/scenarios.py, then api_ysb's job under an
# injected device error and under torn checkpoints, and api_mesh leg A's job
# losing a shard, each against its uninterrupted run
# ---------------------------------------------------------------------------

# leg A/B: api_ysb's program (columnar) at 2^22 records, checkpoints every
# 25 ms, the device error at the 40th of its 64 batches, the real failure of
# leg B at 60% of event time; leg C: api_mesh leg A's program at 2^20 on four
# shards of the card (128 batches of 8192), the device error at the 77th
CHAOS = dict(events=1 << 22, batch=65536, warmup_events=1 << 18, interval=25, device_nth=40,
             fail_at=0.6, mem_slack=1 << 19, mesh_events=1 << 20, mesh_batch=8192, shards=4,
             mesh_nth=77)
# the JAX gate's scenarios whose injected failure must be attributed
# (tests/test_bench_chaos.py::ATTRIBUTED_SCENARIOS)
ATTRIBUTED_SCENARIOS = ("device-dispatch-error", "storage-brownout", "latency-mode-restore")


def _fused_pipe(client):
    return next(r.op.pipe for r in client._runtime.runners
                if type(r).__name__ == "DeviceChainRunner")


def chaos_leg_0(sz, dev) -> dict:
    """The eight in-process scenarios at the JAX package's sizes, the mesh
    ones on four shards of the card."""
    from flink_tpu_torch.chaos.scenarios import (
        CLUSTER_SCENARIOS,
        MESH_SCENARIOS,
        SCENARIOS,
        run_matrix,
    )

    m = run_matrix([n for n in SCENARIOS if n not in CLUSTER_SCENARIOS], device=dev,
                   shards=sz["shards"])
    rows = {}
    for r in m["scenarios"]:
        ok = (r["passed"] and not r["skipped"] and r["injected_fired"] >= 1
              and (r["name"] not in ATTRIBUTED_SCENARIOS or r["attributed"] is True)
              and (r["name"] not in MESH_SCENARIOS
                   or r.get("mesh") == [sz["shards"], sz["shards"] // 2]))
        rows[r["name"]] = dict(r, ok=bool(ok))
    return {"scenarios": rows, "scenarios_total": m["scenarios_total"],
            "scenarios_passed": m["scenarios_passed"], "parity": m["parity"],
            "recovery_time_ms_p50": m["recovery_time_ms_p50"],
            "ok": bool(m["scenarios_total"] == 8 and all(r["ok"] for r in rows.values()))}


def chaos_legs_ab(cz, dev, tmp: str) -> dict:
    """Leg A: api_ysb's job with checkpoints every 25 ms, uninterrupted and
    under an injected device error at its 40th batch, K1 held against its
    plain version at the restarted attempt's first dispatch, over the
    restored ring as loaded, and at its widest (`k1_recovered`). Leg B:
    the same job with every checkpoint from the 3rd torn and one real
    failure at 60% of event time."""
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.harness import fault_injection

    sz = dict(API_CHECKPOINT, events=cz["events"], batch=cz["batch"])
    n, keys = cz["events"], sz["keys"]
    interval = cz["interval"]

    def job(sink, chk):
        # every checkpoint retained, as the JAX scenarios retain 50: torn
        # ones count against the retention, and the restore must find the
        # last complete one behind them
        return ckpt_job(n, sink, sz, interval=interval, chk_dir=f"{tmp}/{chk}",
                        columnar=True, dev=dev,
                        conf={"execution.checkpointing.max-retained": 1 << 20})

    ckpt_run(ckpt_job(cz["warmup_events"], timed_collect_sink(), sz, columnar=True,
                      dev=dev), dev)
    base_sink = timed_collect_sink()
    base = ckpt_run(job(base_sink, "undisturbed"), dev)
    base_fired, base_twice = columnar_fired(base_sink.results, keys)
    par, checked = st.parity(st.api_replay(n, sz["batch"], agg="count", num_keys=keys).fired,
                             base_fired)
    undisturbed = {"seconds": base["seconds"], "tuples_per_s": n / base["seconds"],
                   "k1_launches": base["k1_launches"], **ckpt_stats(base["client"]),
                   "parity_vs_oracle": par and not base_twice, "windows_checked": checked}
    del base_sink, base

    # A: the device error, the restarted attempt's memory and widest dispatch
    sink = FailOnceSink(timed_collect_sink())
    with fault_injection(rules=[{"scope": "device", "fault": "error",
                                 "nth": cz["device_nth"]}]) as plan, \
            K1Tap(lambda: plan.total_fired > 0) as tap:
        run = ckpt_run(job(sink, "device"), dev)
    client = run["client"]
    fired, twice = columnar_fired(sink.inner.results, keys)
    mem = sink.first_write_bytes
    a = {"seconds": run["seconds"], "tuples_per_s": n / run["seconds"],
         "tuples_per_s_over_undisturbed": undisturbed["seconds"] / run["seconds"],
         "k1_launches": run["k1_launches"], "injected_fired": plan.total_fired,
         **ckpt_stats(client), "rows_equal_undisturbed": _fired_equal(fired, base_fired)
         and not twice, "first_write_allocated_bytes": mem,
         "memory_bounded": len(mem) == 2 and mem[1] <= mem[0] + cz["mem_slack"]}
    a["restarted_dispatch_taken"] = tap.taken is not None
    if torch.device(dev).type == "cuda":
        a["k1_recovered"] = tap.check(
            "api_chaos leg A: api_ysb's count job, the restarted attempt's widest dispatch "
            "(first_dispatch: its first, over the restored ring as loaded)", _fused_pipe(client))
    k1 = a.get("k1_recovered", {})
    a["ok"] = bool(a["status"] == "FINISHED" and a["num_restarts"] == 1
                   and a["restored_checkpoint_id"] is not None and a["injected"] == [True]
                   and a["injected_fired"] == 1 and a["rows_equal_undisturbed"]
                   and a["memory_bounded"] and a["restarted_dispatch_taken"]
                   and a["k1_launches"] > 0 and k1.get("max_abs_err") == 0
                   and k1["first_dispatch"]["max_abs_err"] == 0)
    del sink, fired, client, run, tap

    # B: torn checkpoints from the 3rd, a real failure at fail_at
    fail_ts = st.API_T0_MS + int(st.API_SPAN_EVENT_MS * cz["fail_at"])
    sink = FailOnceSink(timed_collect_sink(), fail_ts)
    with fault_injection(rules=[{"scope": "storage", "fault": "torn", "match": "save",
                                 "nth": 3, "max_fires": None}]) as plan:
        run = ckpt_run(job(sink, "torn"), dev)
    fired, twice = columnar_fired(sink.inner.results, keys)
    b = {"seconds": run["seconds"], "tuples_per_s": n / run["seconds"],
         "k1_launches": run["k1_launches"], "torn_saves": plan.total_fired,
         **ckpt_stats(run["client"]),
         "rows_equal_undisturbed": _fired_equal(fired, base_fired) and not twice}
    b["ok"] = bool(b["status"] == "FINISHED" and b["num_restarts"] == 1
                   and b["restored_checkpoint_id"] == 2 and b["torn_saves"] >= 1
                   and b["rows_equal_undisturbed"] and b["k1_launches"] > 0)
    undisturbed["ok"] = bool(undisturbed["parity_vs_oracle"] and undisturbed["num_restarts"] == 0
                             and undisturbed["k1_launches"] > 0)
    return {"events": n, "interval_ms": interval, "undisturbed": undisturbed,
            "leg_a": a, "leg_b": b}


def chaos_leg_c(cz, dev) -> dict:
    """api_mesh leg A's job on four shards of the card with checkpoints and
    parallel.mesh.degrade-on-device-loss, an injected device error at its
    77th batch: one restart on 2 shards, the one-card run's rows."""
    from flink_tpu_torch.testing.harness import fault_injection

    sz, n = dict(API_MESH, batch=cz["mesh_batch"]), cz["mesh_events"]
    card_env, card_sink = mesh_job(n, sz, columnar=True, dev=dev, sink=timed_collect_sink())
    card = ckpt_run(card_env, dev)
    card_fired, card_twice = columnar_fired(card_sink.results, sz["keys"])
    env, sink = mesh_job(n, sz, shards=cz["shards"], columnar=True, dev=dev,
                         sink=timed_collect_sink(),
                         conf={"execution.checkpointing.interval": cz["interval"],
                               "parallel.mesh.degrade-on-device-loss": True,
                               "restart-strategy.type": "fixed-delay",
                               "restart-strategy.initial-backoff": 1})
    with fault_injection(rules=[{"scope": "device", "fault": "error",
                                 "nth": cz["mesh_nth"]}]) as plan:
        run = ckpt_run(env, dev)
    client = run["client"]
    fired, twice = columnar_fired(sink.results, sz["keys"])
    out = {"events": n, "shards": cz["shards"], "seconds": run["seconds"],
           "card_seconds": card["seconds"], "tuples_per_s": n / run["seconds"],
           "card_tuples_per_s": n / card["seconds"], "k1_launches": run["k1_launches"],
           "card_k1_launches": card["k1_launches"], "injected_fired": plan.total_fired,
           **ckpt_stats(client), "mesh_devices_after": client._runtime.mesh_devices(),
           "rows_equal_card": _fired_equal(fired, card_fired) and not twice and not card_twice}
    out["ok"] = bool(out["status"] == "FINISHED" and out["num_restarts"] == 1
                     and out["mesh_devices_after"] == cz["shards"] // 2
                     and out["restored_checkpoint_id"] is not None
                     and out["injected"] == [True] and out["rows_equal_card"]
                     and out["k1_launches"] > 0 and out["card_k1_launches"] > 0)
    return out


def api_chaos_phase(dev=DEV, sizes=None) -> dict:
    """Phase 30: leg 0 (the scenario matrix), legs A and B (api_ysb's job
    under a device error and torn checkpoints) and leg C (a lost shard),
    each faulted run against its uninterrupted run (see CHAOS)."""
    import tempfile

    from flink_tpu_torch.chaos.scenarios import mesh_of

    sz = dict(CHAOS, **(sizes or {}))
    out = {"phase": "api_chaos",
           "card": card_line() if torch.device(dev).type == "cuda" else "cpu"}
    t0 = time.perf_counter()
    out["leg_0"] = dict(chaos_leg_0(sz, dev), phase_s=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ab = chaos_legs_ab(sz, dev, tmp)
        out.update(undisturbed=ab["undisturbed"], leg_a=ab["leg_a"], leg_b=ab["leg_b"],
                   events=ab["events"], interval_ms=ab["interval_ms"],
                   legs_ab_s=time.perf_counter() - t0)
    with mesh_of(_shard_device(dev), sz["shards"]):
        t0 = time.perf_counter()
        out["leg_c"] = dict(chaos_leg_c(sz, dev), phase_s=time.perf_counter() - t0)
    out["ok"] = bool(all(out[k]["ok"] for k in ("leg_0", "undisturbed", "leg_a", "leg_b",
                                                 "leg_c")))
    return out


# ---------------------------------------------------------------------------
# phase 31: api_state_tools, savepoints and formats on the card: a savepoint
# of api_ysb's tumbling sum job read against numpy, patched (sum x 10) and
# resumed on K1; api_ysb's records through FormattedFileSink and
# FormattedFileSource in CSV, JSON lines and Avro into the fused count job
# ---------------------------------------------------------------------------

# leg A: the tumbling sum job at 2^22 records, the savepoint at half of its
# batches; leg B: 2^18 records a format
STATE_TOOLS = dict(events=1 << 22, savepoint_at=0.5, format_events=1 << 18,
                   formats=("csv", "json", "avro"))


def _sum_cells(n: int, lo: int, hi: int):
    """numpy: {(key, window start ms): (count, sum)} of api_ysb's tumbling
    sum job over records [lo, hi) of an n-record stream, and the watermark
    after them (the largest timestamp less 1: out-of-orderness 0)."""
    from flink_tpu_torch.testing import stream as st

    col, ts = st.api_columns(np.arange(lo, hi, dtype=np.int64), n, API["keys"], payload=True)
    keep = col[:, 1] == 0
    keys, vals = col[keep, 0].astype(np.int64), col[keep, 2].astype(np.float64)
    starts = ts[keep] // API["sum_window"] * API["sum_window"]
    cells = {}
    for k, w, v in zip(keys.tolist(), starts.tolist(), vals.tolist()):
        c = cells.get((k, w), (0, 0.0))
        cells[(k, w)] = (c[0] + 1, c[1] + v)
    return cells, int(ts.max()) - 1


def tools_leg_a(sz, dev, tmp: str) -> dict:
    """The savepoint: taken at half the batches (the source held at a gate,
    as api_checkpoint leg B takes it), read by SavepointReader against the
    numpy model of the records before records_in() (its windows that had
    not fired at the model's watermark), patched sum x 10 by
    SavepointWriter, resumed on the card: rows and total against the model
    with the in-flight cells patched; K1 held against its plain version at
    the resumed job's first dispatch, over the patched ring as loaded, and
    at its widest (`k1_patched`)."""
    from flink_tpu_torch.graph.transformation import plan as plan_graph
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.minicluster import MiniCluster
    from flink_tpu_torch.state_processor import SavepointReader, SavepointWriter

    n, B = sz["events"], API["batch"]
    half = (int(n * sz["savepoint_at"]) // B) * B
    gate = SourceGate(half, hold_at=half + 2 * B)
    env1, _sink1 = api_job(n, True, columnar=False, sum_job=True, dev=dev, hook=gate)
    sp = f"{tmp}/savepoint"
    first = gate.savepoint(env1.execute_async("state-tools-savepoint"), sp)

    t0 = time.perf_counter()
    reader = SavepointReader.load(sp)
    uid = next(u for u in reader.operator_uids() if u.startswith("window_aggregate"))
    records = reader.records_in()
    cells = {}
    geom = reader.data["runners"][uid]["operator"]["geometry"]
    for k, s, f in reader.keyed_state(uid):
        cells[(int(k), geom["offset"] + s * geom["g"])] = (int(f["count"]), float(f["sum"]))
    pending = reader.pending_output(uid)
    read_s = time.perf_counter() - t0
    model, wm = _sum_cells(n, 0, records)
    # the model's windows that had not fired at its watermark
    model_live = {c: v for c, v in model.items() if c[1] + API["sum_window"] - 1 > wm}
    in_flight = sum(v for _c, v in cells.values())
    pending_sum = sum(float(v) for _k, _w, v, _t in pending)
    patched = f"{tmp}/patched"
    (SavepointWriter.from_reader(reader)
     .transform_columnar_state(uid, lambda name, arr: arr * 10 if name == "sum" else arr)
     .write(patched))

    env2, sink2 = api_job(n, True, columnar=False, sum_job=True, dev=dev)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    with K1Tap(lambda: True) as tap:
        client2 = MiniCluster.get_shared().submit(plan_graph(env2._sinks), env2.config,
                                                  "state-tools-resumed",
                                                  savepoint_restore_path=patched, device=dev)
        status2 = client2.wait(900)
    _sync(dev)
    resume_s = time.perf_counter() - t0
    launches = cs.LAUNCHES["k1_superscan"]
    rows = {}
    for values, tss in sink2.batches:
        for (k, v), t in zip(values, tss):
            rows[(int(k), int(t) + 1 - API["sum_window"])] = float(v)
    after, _wm = _sum_cells(n, records, n)
    pend = {(int(k), int(w.start)): float(v) for k, w, v, _t in pending}
    want = {}
    for c in set(model_live) | set(after):
        want[c] = model_live.get(c, (0, 0.0))[1] + 9 * cells.get(c, (0, 0.0))[1] + \
            after.get(c, (0, 0.0))[1]
    want.update(pend)
    total = sum(rows.values())
    expected_total = sum(v for _c, (_n, v) in after.items()) + 10 * in_flight + pending_sum
    out = {"events": n, "savepoint_at_record": half, **first, "records_in": records,
           "model_watermark": wm, "in_flight_cells": len(cells),
           "pending_rows": len(pending), "read_s": read_s,
           "reader_equals_model": bool(cells) and cells == model_live,
           "resumed_job": status2.value, "resume_seconds": resume_s,
           "tuples_per_s_resumed": (n - records) / resume_s, "k1_launches": launches,
           "rows": len(rows), "rows_equal_patched_model": rows == want,
           "total": total, "expected_total": expected_total,
           "total_equal": total == expected_total}
    out["resumed_dispatch_taken"] = tap.taken is not None
    if torch.device(dev).type == "cuda":
        out["k1_patched"] = tap.check(
            "api_state_tools leg A: api_ysb's tumbling sum job resumed from the patched "
            "savepoint, its widest dispatch (first_dispatch: its first, over the patched "
            "ring as loaded)", _fused_pipe(client2))
    k1 = out.get("k1_patched", {})
    out["ok"] = bool(first["first_job"] == "CANCELED" and status2.value == "FINISHED"
                     and out["reader_equals_model"] and out["rows_equal_patched_model"]
                     and out["total_equal"] and out["resumed_dispatch_taken"]
                     and launches > 0 and k1.get("max_abs_err") == 0
                     and k1["first_dispatch"]["max_abs_err"] == 0)
    return out


def format_rows(n: int) -> list:
    """api_ysb's first n records as row dicts (campaign, event type, time)."""
    from flink_tpu_torch.testing import stream as st

    col, ts = st.api_columns(np.arange(n, dtype=np.int64), n, API["keys"])
    return [{"campaign": int(c), "event_type": int(e), "ts": int(t)}
            for c, e, t in zip(col[:, 0].tolist(), col[:, 1].tolist(), ts.tolist())]


def format_job(paths, fmt: str, n: int, dev=DEV):
    """(env, sink) of api_ysb's count program over rows read from `paths`
    in format `fmt` (host filter and key over the row dicts, the fused
    operator on the card)."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.core.watermarks import WatermarkStrategy
    from flink_tpu_torch.formats.file_io import FormattedFileSource

    env = StreamExecutionEnvironment(Configuration({
        "execution.step.batch-size": API["batch"],
        "execution.state.key-capacity": API["keys"]}), device=dev)
    sink = rows_sink()
    (env.from_source(FormattedFileSource(paths, format=fmt, timestamp_fn=lambda r: r["ts"]),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
     .filter(lambda r: r["event_type"] == 0).key_by(lambda r: r["campaign"])
     .window(SlidingEventTimeWindows.of(API["window"], API["slide"]))
     .aggregate("count").sink_to(sink))
    return env, sink


def tools_leg_b(sz, dev, tmp: str) -> dict:
    """Each format: the rows through a job into FormattedFileSink, the
    codec's host MB/s each way, then the files through FormattedFileSource
    into the fused count job on the card against the columnar job's rows."""
    import io
    import os

    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.formats import get_format
    from flink_tpu_torch.formats.file_io import FormattedFileSink

    n = sz["format_events"]
    rows = format_rows(n)
    ref_sink, _s, ref_k1 = api_run(n, True, columnar=False, dev=dev)
    ref = api_fired(ref_sink, API["window"], API["slide"])
    out = {"events": n, "reference_k1": ref_k1}
    ok = ref_k1 > 0
    for fmt in sz["formats"]:
        d = f"{tmp}/{fmt}"
        env = StreamExecutionEnvironment(device=dev)
        env.from_collection(rows).sink_to(FormattedFileSink(d, format=fmt))
        t0 = time.perf_counter()
        env.execute(f"write-{fmt}")
        write_job_s = time.perf_counter() - t0
        paths = sorted(os.path.join(d, p) for p in os.listdir(d) if not p.startswith("."))
        nbytes = sum(os.path.getsize(p) for p in paths)
        codec = get_format(fmt)
        buf = io.BytesIO()
        t0 = time.perf_counter()
        codec.write(rows, buf)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = codec.read(io.BytesIO(buf.getvalue()))
        dec_s = time.perf_counter() - t0
        env2, sink = format_job(paths, fmt, n, dev)
        _sync(dev)
        from flink_tpu_torch.ops import cuda_superscan as cs

        cs.reset_launch_counts()
        t0 = time.perf_counter()
        env2.execute(f"read-{fmt}")
        _sync(dev)
        read_job_s = time.perf_counter() - t0
        k1 = cs.LAUNCHES["k1_superscan"]
        got = api_fired(sink, API["window"], API["slide"])
        leg = {"files": len(paths), "bytes": nbytes, "write_job_s": write_job_s,
               "read_job_s": read_job_s, "read_job_tuples_per_s": n / read_job_s,
               "encode_mb_per_s": len(buf.getvalue()) / enc_s / 1e6,
               "decode_mb_per_s": len(buf.getvalue()) / dec_s / 1e6,
               "codec_roundtrip": back == rows, "k1_launches": k1,
               "rows_equal_columnar_job": _fired_equal(got, ref)}
        leg["ok"] = bool(leg["rows_equal_columnar_job"] and leg["codec_roundtrip"]
                         and leg["files"] == 1 and k1 > 0)
        ok = ok and leg["ok"]
        out[fmt] = leg
        del back, buf, got, sink
    out["ok"] = bool(ok)
    return out


def chaos_main_thread_run(dev=DEV) -> float:
    """Leg A's faulted job (CHAOS sizes) through the MiniCluster's attempt
    loop driven on the calling thread, so cProfile sees the failure, the
    restore and the restarted attempt: seconds."""
    import shutil
    import tempfile

    from flink_tpu_torch.graph.transformation import plan
    from flink_tpu_torch.runtime.minicluster import JobClient, MiniCluster
    from flink_tpu_torch.testing.harness import fault_injection

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_profile_")
    try:
        sz = dict(API_CHECKPOINT, events=CHAOS["events"], batch=CHAOS["batch"])
        env = ckpt_job(CHAOS["events"], timed_collect_sink(), sz, interval=CHAOS["interval"],
                       chk_dir=tmp, columnar=True, dev=dev)
        client = JobClient("chaos-profile", "chaos-profile")
        _sync(dev)
        t0 = time.perf_counter()
        with fault_injection(rules=[{"scope": "device", "fault": "error",
                                     "nth": CHAOS["device_nth"]}]):
            MiniCluster()._run_job(client, plan(env._sinks), env.config, None,
                                   torch.device(dev))
        _sync(dev)
        if client.num_restarts != 1:
            raise AssertionError("api_chaos profile run: expected one restart")
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def format_read_run(fmt: str, dev=DEV) -> float:
    """Leg B's read job for one format over STATE_TOOLS' records, the file
    written first: seconds of the job alone."""
    import shutil
    import tempfile

    from flink_tpu_torch.formats import get_format

    tmp = tempfile.mkdtemp(prefix="chip_smoke_format_profile_")
    try:
        n = STATE_TOOLS["format_events"]
        path = f"{tmp}/rows.{fmt}"
        get_format(fmt).write_file(format_rows(n), path)
        env, _sink = format_job([path], fmt, n, dev)
        _sync(dev)
        t0 = time.perf_counter()
        env.execute(f"read-{fmt}")
        _sync(dev)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def api_state_tools_phase(dev=DEV, sizes=None) -> dict:
    """Phase 31: leg A (a patched savepoint) and leg B (formats), see
    STATE_TOOLS."""
    import tempfile

    sz = dict(STATE_TOOLS, **(sizes or {}))
    out = {"phase": "api_state_tools",
           "card": card_line() if torch.device(dev).type == "cuda" else "cpu"}
    for leg, fn in (("leg_a", tools_leg_a), ("leg_b", tools_leg_b)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out[leg] = dict(fn(sz, dev, tmp), phase_s=time.perf_counter() - t0)
    out["ok"] = bool(out["leg_a"]["ok"] and out["leg_b"]["ok"])
    return out


# ---------------------------------------------------------------------------
# phase 32, api_cluster: the distributed cluster (runtime/cluster.py) over
# the authenticated RPC and columnar data planes, with its TaskExecutors on
# the card; ML_PREDICT over a torch model
# ---------------------------------------------------------------------------

# leg A: api_ysb's fused program at 2^22 records (batch 65536, 8192 keys)
# on one JobManager and two TaskExecutors; leg B: the same program split
# before the window at 2^21 records, paced 0.1 s a batch, checkpoints every
# 0.2 s, a TaskExecutor lost after the first checkpoint (a 5 s heartbeat
# timeout: the in-process TaskExecutors' beats share the job's GIL, and a
# 1.5 s timeout lost live ones on the card); leg C: two shards
# of a sliding count and a session sum over 2^20 records each; leg D:
# ML_PREDICT over 2^16 rows; leg E: leg A's job at 2^20 records on a
# jobmanager and a taskmanager process
API_CLUSTER = dict(events_a=1 << 22, events_b=1 << 21, events_e=1 << 20, keys=8192,
                   batch=65536, window=10_000, slide=1_000, delay_b=0.1,
                   superbatch_b=4, interval_b=0.2, heartbeat_timeout_b=5.0,
                   c_steps=16, c_batch=1 << 16,
                   c_keys=1024, gap=2000, ml_rows=1 << 16, hidden=64, wire_rows=65536,
                   wire_reps=20, handshakes=50, mem_slack=512 << 10)


class _PipeTap:
    """Keeps every FusedWindowPipeline built while it is installed (the
    geometry K1's check needs of a pipeline inside a TaskExecutor)."""

    def __enter__(self):
        from flink_tpu_torch.runtime import fused_window_pipeline as fwp

        self.pipes, self._cls = [], fwp.FusedWindowPipeline
        real, pipes = self._cls.__init__, self.pipes

        def init(pipe, *a, **kw):
            real(pipe, *a, **kw)
            pipes.append(pipe)

        self._real = real
        self._cls.__init__ = init
        return self

    def __exit__(self, *exc):
        self._cls.__init__ = self._real
        return False


class _RunnerTap:
    """Records the runner classes of every JobRuntime built while it is
    installed (a stage's selected runner)."""

    def __enter__(self):
        from flink_tpu_torch.runtime import executor as ex

        self.built, self._ex, self._real = [], ex, ex.build_runners
        built, real = self.built, self._real

        def build(graph, config, device=None):
            runners, feeds = real(graph, config, device)
            built.append([type(r).__name__ for r in runners])
            return runners, feeds

        ex.build_runners = build
        return self

    def __exit__(self, *exc):
        self._ex.build_runners = self._real
        return False


class _Cluster:
    """A JobManager and TaskExecutors in this process, all on one ephemeral
    secret; stopped on exit."""

    def __init__(self, sec, dev, tms=2, tm_kw=None, **jm_kw):
        from flink_tpu_torch.runtime.cluster import JobManagerEndpoint
        from flink_tpu_torch.runtime.rpc import RpcService

        self.sec, self.dev, self.tm_kw = sec, dev, tm_kw or {}
        self.svcs = [RpcService(security=sec)]
        jm_kw.setdefault("heartbeat_interval", 0.2)
        jm_kw.setdefault("heartbeat_timeout", 10.0)
        self.jm = JobManagerEndpoint(self.svcs[0], **jm_kw)
        self.tes = []
        for _ in range(tms):
            self.add_tm()
        self.client = self.svcs[0].gateway(self.svcs[0].address, "jobmanager",
                                           reply_timeout=300.0)

    def add_tm(self):
        from flink_tpu_torch.runtime.cluster import TaskExecutorEndpoint
        from flink_tpu_torch.runtime.rpc import RpcService

        svc = RpcService(security=self.sec)
        te = TaskExecutorEndpoint(svc, slots=1, device=self.dev, **self.tm_kw)
        te.connect(self.svcs[0].address)
        self.svcs.append(svc)
        self.tes.append(te)
        return te

    def kill_tm(self, i):
        """Stop TaskExecutor i as its process would die: its endpoints stop,
        its task threads end (they leave at their next cancellation check)
        and their device memory is collected."""
        import gc

        te = self.tes[i]
        te.stop()
        self.svcs[i + 1].stop()
        for task in list(te._tasks.values()):
            task.thread.join(60)
        gc.collect()

    def wait(self, job, done=("FINISHED", "FAILED", "CANCELED"), timeout=600.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.client.job_status(job)
            if st["status"] in done:
                return st
            time.sleep(0.02)
        raise AssertionError(f"api_cluster: job {job} not in {done} within {timeout} s: {st}")

    def until(self, pred, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = pred()
            if got:
                return got
            time.sleep(0.02)
        raise AssertionError(f"api_cluster: timed out waiting for {what}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for te in self.tes:
            te.stop()
        self.jm.heartbeats.stop()
        for s in self.svcs:
            s.stop()
        return False


def _api_fired_rows(rows, keys: int, window_ms: int, slide_ms: int) -> dict:
    """fired_rows' (max timestamp, key, count) as {window index: row over
    the keys}, as api_fired reads a sink."""
    fired = {}
    for t, k, v in rows:
        row = fired.setdefault((t + 1 - window_ms) // slide_ms, np.zeros(keys))
        row[k] = v
    return fired


def cluster_leg_a(sz, dev, sec) -> dict:
    """Leg A's job (columnar output) locally (env.execute) and on the
    cluster, after a warm-up run at a sixteenth of its records, against
    each other and the numpy oracle; K1 counted in the TaskExecutor and
    held against its plain version at its first full dispatch there
    (`k1_cluster`)."""
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.testing import cluster_jobs as cj
    from flink_tpu_torch.testing import stream as st

    n = sz["events_a"]
    kw = dict(keys=sz["keys"], batch=sz["batch"], window_ms=sz["window"],
              slide_ms=sz["slide"], device=dev)
    warm, _sink = cj.api_graph(n // 16, **kw)   # the kernels built, the process warm
    warm.execute()
    env, sink = cj.api_graph(n, **kw)
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    env.execute()
    _sync(dev)
    local_s = time.perf_counter() - t0
    local_k1 = cs.LAUNCHES["k1_superscan"]
    local = cj.fired_rows(sink.results)
    del env, sink
    t0 = time.perf_counter()
    ref = st.api_replay(n, sz["batch"], window_ms=sz["window"], slide_ms=sz["slide"],
                        agg="count", num_keys=sz["keys"])
    oracle_s = time.perf_counter() - t0
    oracle_ok, checked = st.parity(ref.fired, _api_fired_rows(local, sz["keys"], sz["window"],
                                                              sz["slide"]), require_all=True)
    spec = cj.api_graph_spec("api-cluster-a", n, **kw)
    with _Cluster(sec, dev) as c, _PipeTap() as pt, K1Tap() as tap:
        _sync(dev)
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        job = c.client.submit_job(spec.to_bytes(), 1)
        status = c.wait(job)
        cluster_s = time.perf_counter() - t0
        launches = cs.LAUNCHES["k1_superscan"]
        t0 = time.perf_counter()
        got = cj.fired_rows(c.client.job_result(job) or [])
        result_s = time.perf_counter() - t0
        k1 = (tap.check("api_cluster leg A: api_ysb's fused program in a TaskExecutor, its "
                        "widest dispatch (first_dispatch: its first full one)", pt.pipes[-1])
              if torch.device(dev).type == "cuda" and pt.pipes else {})
    out = {"events": n, "status": status["status"], "rows": len(got),
           "rows_equal_local": got == local, "local_equal_oracle": oracle_ok,
           "windows_checked": checked, "k1_launches_task_executor": launches,
           "k1_launches_local": local_k1, "cluster_seconds": cluster_s,
           "local_seconds": local_s, "result_fetch_s": result_s, "oracle_s": oracle_s,
           "tuples_per_s_cluster": n / cluster_s, "tuples_per_s_local": n / local_s,
           "pipelines_in_task_executor": len(pt.pipes)}
    if k1:
        out["k1_cluster"] = k1
    out["ok"] = bool(status["status"] == "FINISHED" and got == local and oracle_ok
                     and launches > 0 and (not k1 or (k1["max_abs_err"] == 0 and
                                                      k1["first_dispatch"]["max_abs_err"] == 0)))
    return out


def cluster_leg_b(sz, dev, sec, tmp: str) -> dict:
    """Leg B: the program split before the window (two stages, two tasks
    on two TaskExecutors, the binary wire), paced, checkpoints every
    interval_b; after the first completed checkpoint (and K1's first
    launch and first rows) one TaskExecutor is stopped and another
    connects. The job finishes with the uninterrupted run's rows; the
    device memory at the restarted attempt's first sink batch against the
    first attempt's."""
    from flink_tpu_torch.config import ExecutionOptions
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.testing import cluster_jobs as cj

    n = sz["events_b"]
    kw = dict(keys=sz["keys"], batch=sz["batch"], window_ms=sz["window"],
              slide_ms=sz["slide"], device=dev)
    env, sink = cj.api_graph(n, **kw)
    env.execute()
    want = cj.fired_rows(sink.results)
    del env, sink
    label = f"api-cluster-b-{time.monotonic_ns()}"
    spec = cj.api_graph_spec("api-cluster-b", n, stages=True, **kw, label=label,
                             gen=cj.ApiGen(n, sz["keys"], delay_s=sz["delay_b"]))
    firsts = cj.FIRST_WRITE_BYTES.setdefault(label, [])
    spec.config.set(ExecutionOptions.SUPERBATCH_STEPS, sz["superbatch_b"])
    out = {"events": n}
    with _Cluster(sec, dev, tm_kw={"shipping_interval_ms": 100},
                  checkpoint_dir=f"{tmp}/chk-b", checkpoint_interval=sz["interval_b"],
                  restart_attempts=3, restart_delay=0.2,
                  heartbeat_timeout=sz["heartbeat_timeout_b"],
                  adaptive=False) as c, _RunnerTap() as rt:
        _sync(dev)
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        job = c.client.submit_job(spec.to_bytes(), 1)
        cuda = torch.device(dev).type == "cuda"

        def k1_seen():
            return not cuda or cs.LAUNCHES["k1_superscan"] > 0

        c.until(lambda: c.client.job_status(job)["checkpoints"] and k1_seen() and firsts,
                120, "leg B's first checkpoint and first rows")
        out["first_attempt_k1"] = cs.LAUNCHES["k1_superscan"]
        out["checkpoint_before_loss"] = c.client.job_status(job)["checkpoints"][-1]
        t_loss = time.perf_counter()
        c.kill_tm(1)
        c.add_tm()
        cs.reset_launch_counts()
        status = c.wait(job)
        secs = time.perf_counter() - t0
        out["restart_to_k1_s"] = time.perf_counter() - t_loss
        got = cj.fired_rows(c.client.job_result(job) or [])
        exc = c.client.job_exceptions(job)
        metrics = c.client.job_metrics(job).get("job", {})
    exch = {k: v for k, v in metrics.items() if isinstance(v, (int, float)) and (
        "exchange" in k or k.endswith(".backPressuredTimeMsTotal"))}

    def total(leaf):
        # per-channel keys (job.exchange.numBytesOut.<edge>) and per-runner
        # ones (job.operator.<uid>.backPressuredTimeMsTotal)
        return sum(v for k, v in exch.items()
                   if leaf in k.split(".") and not k.endswith("PerSecond"))

    recov = exc["recoveries"][-1] if exc.get("recoveries") else {}
    window_runners = sorted({r for rs in rt.built for r in rs
                             if "Window" in r or "DeviceChain" in r})
    out.update({
        "status": status["status"], "restarts": status["restarts"], "seconds": secs,
        "stages": status.get("stages"), "rows": len(got), "rows_equal_uninterrupted": got == want,
        "restored_checkpoint_id": recov.get("restored_checkpoint_id"),
        "window_stage_runners": window_runners, "runner_sets": rt.built,
        "k1_launches_restarted": cs.LAUNCHES["k1_superscan"],
        "exchange": {"numBytesOut": total("numBytesOut"), "numBytesIn": total("numBytesIn"),
                     "inPoolUsage": max([v for k, v in exch.items() if "inPoolUsage" in k],
                                        default=None),
                     "backPressuredTimeMsTotal": total("backPressuredTimeMsTotal"),
                     "keys": sorted(exch)[:24]},
        # at each attempt's first sink batch (api_checkpoint's measure)
        "device_memory_first": firsts[0], "device_memory_restarted": firsts[-1],
        "device_memory_delta": firsts[-1] - firsts[0], "first_writes": len(firsts)})
    out["ok"] = bool(status["status"] == "FINISHED" and got == want and status["restarts"] >= 1
                     and out["restored_checkpoint_id"] is not None and len(firsts) >= 2
                     and out["device_memory_delta"] <= sz["mem_slack"])
    return out


def _sliding_oracle(keys, ts, window_ms: int, slide_ms: int) -> dict:
    """{(key, window start): count} of a sliding count over every record
    (one bincount over key x window-start cells)."""
    per = window_ms // slide_ms
    starts = (ts // slide_ms)[:, None] - np.arange(per)[None, :]   # in slides
    lo = int(starts.min())
    span = int(starts.max()) - lo + 1
    counts = np.bincount((np.repeat(keys, per) * span + (starts.reshape(-1) - lo)))
    return {(int(c) // span, (int(c) % span + lo) * slide_ms): int(counts[c])
            for c in np.flatnonzero(counts)}


def cluster_leg_c(sz, dev, sec) -> dict:
    """Leg C: DistributedJobSpec(operator="device") on two shards of two
    TaskExecutors: a sliding count on TpuWindowOperator and a session sum
    on TpuSessionWindowOperator (K3/K4), each against numpy."""
    from flink_tpu_torch.api.windowing.assigners import (
        EventTimeSessionWindows,
        SlidingEventTimeWindows,
    )
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.runtime.cluster import DistributedJobSpec
    from flink_tpu_torch.testing import cluster_jobs as cj
    from flink_tpu_torch.testing import stream as st

    T, B = sz["c_steps"], sz["c_batch"]
    out = {"events": T * B}
    sliding = cj.ApiShardSource(T, B, sz["c_keys"])
    keys, ts = sliding.records(np.arange(T * B, dtype=np.int64))
    want_sliding = _sliding_oracle(keys, ts, sz["window"], sz["slide"])
    recs = st.session_records(np.arange(T * B, dtype=np.int64), B)
    want_sessions = st.numpy_sessionize(recs[0], recs[1], recs[2].astype(np.float64), sz["gap"])
    specs = {
        "sliding_count": DistributedJobSpec(
            name="api-cluster-c-sliding", source_factory=sliding,
            assigner=SlidingEventTimeWindows.of(sz["window"], sz["slide"]), aggregate="count",
            operator="device", operator_options=None),
        "session_sum": DistributedJobSpec(
            name="api-cluster-c-sessions", source_factory=cj.SessionShardSource(T, B),
            assigner=EventTimeSessionWindows.with_gap(sz["gap"]), aggregate="sum",
            operator="device", operator_options={"key_capacity": 4 * st.SESSION_BLOCK_KEYS}),
    }
    with _Cluster(sec, dev) as c:
        for name, spec in specs.items():
            _sync(dev)
            cuda_session.reset_launch_counts()
            t0 = time.perf_counter()
            job = c.client.submit_job(spec.to_bytes(), 2)
            status = c.wait(job)
            secs = time.perf_counter() - t0
            rows = c.client.job_result(job) or []
            if name == "sliding_count":
                got = {(int(k), int(w[0])): int(r) for k, w, r, _t in rows}
                equal = got == want_sliding
            else:
                got = {(int(k), int(w[0]), int(w[1])): float(r) for k, w, r, _t in rows}
                equal = got == want_sessions
            out[name] = {"status": status["status"], "rows": len(got), "equal_numpy": equal,
                         "seconds": secs, "tuples_per_s": T * B / secs,
                         "k3_launches": cuda_session.k3_launches(),
                         "k4_launches": cuda_session.LAUNCHES["k4_session_merge"]}
    sess = out["session_sum"]
    out["ok"] = bool(all(out[n]["status"] == "FINISHED" and out[n]["equal_numpy"]
                         for n in specs)
                     and (torch.device(dev).type != "cuda"
                          or (sess["k3_launches"] > 0 and sess["k4_launches"] > 0)))
    return out


def _mlp(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def cluster_leg_d(sz, dev) -> dict:
    """Leg D: SQL ML_PREDICT over a two-layer MLP (weights from a numpy
    seed, carried with params_from_numpy) on 2^16 rows, on `dev` and on
    the CPU: the scores in row order within 1e-5 relative."""
    from flink_tpu_torch.api.datastream import StreamExecutionEnvironment
    from flink_tpu_torch.table import TableEnvironment, TableSchema
    from flink_tpu_torch.table.ml import TorchModelProvider, params_from_numpy

    rng = np.random.default_rng(2026)
    h = sz["hidden"]
    params = {"w1": (rng.standard_normal((2, h)) / np.sqrt(2)).astype(np.float32),
              "b1": (rng.standard_normal(h) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((h, 1)) / np.sqrt(h)).astype(np.float32),
              "b2": np.zeros(1, np.float32)}
    x = rng.standard_normal((sz["ml_rows"], 2)).astype(np.float32)
    rows = [{"user": i, "x1": float(a), "x2": float(b)} for i, (a, b) in enumerate(x)]
    res = {}
    for where in (dev, "cpu"):
        tenv = TableEnvironment(StreamExecutionEnvironment(device=where))
        tenv.from_rows("clicks", rows, TableSchema(["user", "x1", "x2"]))
        tenv.register_model("scorer", TorchModelProvider(
            _mlp, params_from_numpy(params, where), ["x1", "x2"], ["score"], device=where))
        _sync(where)
        t0 = time.perf_counter()
        out = tenv.execute_sql_to_list(
            "SELECT user, ML_PREDICT(scorer, x1, x2) AS score FROM clicks")
        _sync(where)
        res[where] = (time.perf_counter() - t0, out)
    secs, got = res[dev]
    _s, ref = res["cpu"]
    order = [r["user"] for r in got] == [r["user"] for r in ref] == list(range(len(rows)))
    a = np.array([r["score"] for r in got])
    b = np.array([r["score"] for r in ref])
    err = np.abs(a - b)
    # within 1e-5 relative: |a - b| <= 1e-5 |b| + 1e-6 for every row (the
    # 1e-6 floor for scores near 0, where fp32 rounding of the sums is
    # ~1e-7 absolute); the norm-wise relative error beside it
    close = bool(np.all(err <= 1e-5 * np.abs(b) + 1e-6))
    return {"rows": len(got), "row_order_equal": order, "within_tolerance": close,
            "max_abs_err": float(err.max()),
            "normwise_rel_err": float(err.max() / np.abs(b).max()),
            "max_elementwise_rel_err": float(np.max(err / np.maximum(np.abs(b), 1e-30))),
            "seconds": secs, "rows_per_s": len(got) / secs, "cpu_seconds": res["cpu"][0],
            "ok": bool(order and close and len(got) == sz["ml_rows"])}


def cluster_leg_e(sz, dev, tmp: str) -> dict:
    """Leg E: `python -m flink_tpu_torch.runtime.cluster jobmanager` and
    one `taskmanager` process on the card, the secret given by file; leg
    A's job at events_e records, its rows against the local run. Both
    processes are killed in `finally`."""
    import os
    import secrets as _secrets
    import socket

    from flink_tpu_torch.runtime.rpc import RpcService
    from flink_tpu_torch.security.transport import SecurityConfig
    from flink_tpu_torch.testing import cluster_jobs as cj

    n = sz["events_e"]
    kw = dict(keys=sz["keys"], batch=sz["batch"], window_ms=sz["window"],
              slide_ms=sz["slide"], device=dev)
    env, sink = cj.api_graph(n, **kw)
    env.execute()
    want = cj.fired_rows(sink.results)
    del env, sink
    secret = f"{tmp}/cluster.secret"
    with open(secret, "w") as f:
        f.write(_secrets.token_hex(16))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = str(Path(__file__).resolve().parent)
    env_vars = dict(os.environ, PYTHONPATH=root)
    procs = []

    def spawn(*args):
        p = subprocess.Popen([sys.executable, "-m", "flink_tpu_torch.runtime.cluster", *args,
                              "--secret-file", secret], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env_vars, cwd=root)
        procs.append(p)
        return p

    def line(p, needle, timeout=120.0):
        deadline = time.monotonic() + timeout
        seen = []
        while time.monotonic() < deadline:
            got = p.stdout.readline().decode(errors="replace")
            seen.append(got)
            if needle in got:
                return got
            if p.poll() is not None and not got:
                break
        raise AssertionError(f"api_cluster leg E: no {needle!r}: {''.join(seen)[-2000:]}")

    out = {"events": n}
    svc = None
    try:
        t0 = time.perf_counter()
        jm = spawn("jobmanager", "--port", str(port))
        line(jm, "jobmanager listening")
        out["jobmanager_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # on the card the taskmanager takes its default device (cuda); a
        # CPU rehearsal must ask for the CPU
        tm = spawn("taskmanager", "--jobmanager", f"127.0.0.1:{port}",
                   *(() if torch.device(dev).type == "cuda" else ("--device", "cpu")))
        line(tm, "registered with")
        out["taskmanager_start_to_registration_s"] = time.perf_counter() - t0
        with open(secret, "rb") as f:
            svc = RpcService(security=SecurityConfig.with_secret(f.read().strip()))
        client = svc.gateway(f"127.0.0.1:{port}", "jobmanager", reply_timeout=300.0)
        t0 = time.perf_counter()
        job = client.submit_job(cj.api_graph_spec("api-cluster-e", n, **kw).to_bytes(), 1)
        deadline = time.monotonic() + 300
        st_ = client.job_status(job)
        while st_["status"] not in ("FINISHED", "FAILED") and time.monotonic() < deadline:
            time.sleep(0.05)
            st_ = client.job_status(job)
        out["seconds"] = time.perf_counter() - t0
        got = cj.fired_rows(client.job_result(job) or [])
        out.update({"status": st_["status"], "failure": st_.get("failure"), "rows": len(got),
                    "rows_equal_local": got == want, "tuples_per_s": n / out["seconds"]})
    finally:
        if svc is not None:
            svc.stop()
        for p in procs:
            p.kill()
            p.wait(timeout=30)
            p.stdout.close()
    out["processes_stopped"] = all(p.returncode is not None for p in procs)
    out["ok"] = bool(out.get("status") == "FINISHED" and out.get("rows_equal_local")
                     and out["processes_stopped"])
    return out


def transport_host_rates(sz) -> dict:
    """Host numbers of the new planes on this machine's CPU: the binary
    wire's encode and decode MB/s of a wire_rows x 3 float32 batch with its
    timestamps, and the handshake's ms over a socket pair."""
    import socket
    import threading

    from flink_tpu_torch.security import transport, wire
    from flink_tpu_torch.testing.harness import ephemeral_transport_security

    rng = np.random.default_rng(1)
    payload = ("b", rng.random((sz["wire_rows"], 3)).astype(np.float32),
               np.arange(sz["wire_rows"], dtype=np.int64))
    nbytes = payload[1].nbytes + payload[2].nbytes
    reps = sz["wire_reps"]
    t0 = time.perf_counter()
    for _ in range(reps):
        cols, side = wire.extract_columns(payload)
        parts, _n = wire.encode_frame("c", 1, cols, side)
        body = bytearray(b"".join(bytes(p) for p in parts))
    enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        _ch, _seq, got = wire.decode_frame(body)
    dec = time.perf_counter() - t0
    same = bool(np.array_equal(got[1], payload[1]) and np.array_equal(got[2], payload[2]))
    sec = ephemeral_transport_security()
    hs = []
    for _ in range(sz["handshakes"]):
        a, b = socket.socketpair()
        t = threading.Thread(target=transport.server_handshake, args=(a, sec))
        t0 = time.perf_counter()
        t.start()
        transport.client_handshake(b, sec)
        t.join()
        hs.append((time.perf_counter() - t0) * 1e3)
        a.close()
        b.close()
    return {"where": "host CPU of the card's machine", "batch_rows": sz["wire_rows"],
            "batch_bytes": nbytes, "encode_MB_per_s": nbytes * reps / enc / 1e6,
            "decode_MB_per_s": nbytes * reps / dec / 1e6, "decode_equal": same,
            "handshake_ms_median": float(np.median(hs)), "handshake_ms_min": float(min(hs))}


def api_cluster_phase(dev=DEV, sizes=None) -> dict:
    """Phase 32: legs A-E with transport security on (one ephemeral secret
    for the in-process legs, a secret file for leg E), the k1_cluster
    check and the planes' host rates."""
    import tempfile

    from flink_tpu_torch.testing.harness import ephemeral_transport_security

    sz = dict(API_CLUSTER, **(sizes or {}))
    sec = ephemeral_transport_security("api-cluster")
    out = {"phase": "api_cluster"}
    with tempfile.TemporaryDirectory(prefix="api-cluster-") as tmp:
        for name, leg in (("leg_a", lambda: cluster_leg_a(sz, dev, sec)),
                          ("leg_b", lambda: cluster_leg_b(sz, dev, sec, tmp)),
                          ("leg_c", lambda: cluster_leg_c(sz, dev, sec)),
                          ("leg_d", lambda: cluster_leg_d(sz, dev)),
                          ("leg_e", lambda: cluster_leg_e(sz, dev, tmp))):
            t0 = time.perf_counter()
            out[name] = leg()
            out[name]["leg_s"] = time.perf_counter() - t0
            print(f"api_cluster {name}: ok={out[name]['ok']} {out[name]['leg_s']:.1f} s",
                  file=sys.stderr, flush=True)
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    out["host_rates"] = transport_host_rates(sz)
    out["failed"] = [leg for leg in ("leg_a", "leg_b", "leg_c", "leg_d", "leg_e")
                     if not out[leg]["ok"]]
    out["ok"] = not out["failed"]
    return out


# ---------------------------------------------------------------------------
# phase 33: api_cluster_ops, the chaos plane's cluster drills, two of their
# fault plans over api_cluster leg B's K1 job, and the HTTP planes and the
# CLI over K1 jobs
# ---------------------------------------------------------------------------

# leg B: api_cluster leg B's job (2^21 records, batch 65536 over 8192 keys,
# 10 s / 1 s), the blip paced 0.1 s a batch (its 5th stage-edge send after
# the first checkpoint fails), the partition 0.3 s (so the job outlives the
# 5 s heartbeat timeout); leg C: api_ysb's fused job at 2^22,
# a checkpointed job at 2^20 paced 0.25 s a batch (it runs ~4 s, past its
# savepoint, flame graph and cancel)
API_CLUSTER_OPS = dict(events_b=1 << 21, keys=8192, batch=65536, window=10_000, slide=1_000,
                       superbatch_b=4, interval_b=0.2, heartbeat_timeout_b=5.0,
                       delay_blip=0.1, blip_nth=5, delay_partition=0.3, partition_fires=80,
                       events_c=1 << 22, events_paced=1 << 20, delay_paced=0.25,
                       paced_interval_ms=50, flame_s=0.2)


def _task_attempt(name=None) -> tuple:
    """(attempt, shard) of the TaskExecutor task whose thread has `name`
    (default: this thread's; `task-<job>-a<attempt>-s<shard>`), else (0, -1)."""
    import re
    import threading

    m = re.match(r"task-\w+-a(\d+)-s(\d+)$", name or threading.current_thread().name)
    return (int(m.group(1)), int(m.group(2))) if m else (0, -1)


def k1_by_attempt(shard=None) -> dict:
    """K1's launches since the last `reset_launch_counts()` by the attempt
    of the TaskExecutor task that launched them (of `shard`'s tasks only,
    when given), from the wrapper's own count by thread; launches from other
    threads (a check against the plain version) are no attempt's."""
    from flink_tpu_torch.ops import cuda_superscan as cs

    out = {}
    for name, n in list(cs.LAUNCHES_BY_THREAD["k1_superscan"].items()):
        attempt, s = _task_attempt(name)
        if attempt and shard in (None, s):
            out[attempt] = out.get(attempt, 0) + n
    return out


def ops_leg_a(dev) -> dict:
    """The four cluster scenarios through run_matrix, their TaskExecutors on
    `dev`: each passed (the JAX gate), with parity, not skipped, fired;
    heartbeat-partition restarted, rpc-flap and dataplane-blip did not."""
    from flink_tpu_torch.chaos.scenarios import CLUSTER_SCENARIOS, run_matrix

    m = run_matrix(list(CLUSTER_SCENARIOS), device=dev)
    rows = {}
    for r in m["scenarios"]:
        ok = (r["passed"] and r["parity"] and not r["skipped"] and r["path"] == "distributed"
              and r["injected_fired"] >= 1)
        if r["name"] == "heartbeat-partition":
            ok = ok and r["restarts"] >= 1
        if r["name"] in ("rpc-flap", "dataplane-blip"):
            ok = ok and r["restarts"] == 0
        rows[r["name"]] = dict(r, ok=bool(ok))
    return {"scenarios": rows, "scenarios_total": m["scenarios_total"],
            "scenarios_passed": m["scenarios_passed"], "parity": m["parity"],
            "recovery_time_ms_p50": m["recovery_time_ms_p50"],
            "ok": bool(m["scenarios_total"] == 4 and all(r["ok"] for r in rows.values()))}


def ops_leg_b(sz, dev, c) -> dict:
    """Leg B on cluster `c` (three TaskExecutors): the blip on the stage
    edge, then the partition of the window stage's TaskExecutor, each
    against the uninterrupted rows; K1 at the restarted attempt's widest
    dispatch (`k1_cluster_faulted`)."""
    from flink_tpu_torch.config import ExecutionOptions
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.stages import cross_edges
    from flink_tpu_torch.testing import cluster_jobs as cj
    from flink_tpu_torch.testing.harness import fault_injection

    n, keys = sz["events_b"], sz["keys"]
    kw = dict(keys=keys, batch=sz["batch"], window_ms=sz["window"], slide_ms=sz["slide"],
              device=dev)
    env, sink = cj.api_graph(n, **kw)
    env.execute()
    want = cj.fired_rows(sink.results)
    del env, sink
    cuda = torch.device(dev).type == "cuda"

    def spec(name, delay):
        sp = cj.api_graph_spec(name, n, stages=True, **kw, gen=cj.ApiGen(n, keys, delay_s=delay))
        sp.config.set(ExecutionOptions.SUPERBATCH_STEPS, sz["superbatch_b"])
        return sp

    def every_attempt(window_shard, attempts):
        by = k1_by_attempt(window_shard)
        return all(by.get(a, 0) > 0 for a in range(1, attempts + 1))

    def first_checkpoint(job, window_shard):
        # and on the card the window stage's first K1 launch
        c.until(lambda: c.client.job_status(job)["checkpoints"]
                and (not cuda or k1_by_attempt(window_shard)), 120,
                "leg B's first checkpoint and the window stage's first K1 launch")

    out = {"events": n}
    # B1: dataplane-blip's error on the stage edge (channel .../x0) once the
    # first checkpoint is complete: the stage fails over, as in the JAX
    # package (its stage edge takes no reconnect window)
    blip_spec = spec("api-cluster-ops-blip", sz["delay_blip"])
    (edge,) = cross_edges(blip_spec.graph)
    window_shard = edge.dst_stage
    _sync(dev)
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    job = c.client.submit_job(blip_spec.to_bytes(), 1)
    first_checkpoint(job, window_shard)
    with fault_injection(rules=[{"scope": "dataplane", "fault": "error",
                                 "match": f"/{edge.edge_id}", "nth": sz["blip_nth"],
                                 "max_fires": 1}]) as plan:
        st_ = c.wait(job)
    secs = time.perf_counter() - t0
    launches = cs.LAUNCHES["k1_superscan"]
    got = cj.fired_rows(c.client.job_result(job) or [])
    recov = c.client.job_exceptions(job).get("recoveries") or [{}]
    blip = {"job": job, "status": st_["status"], "restarts": st_["restarts"],
            "injected_fired": plan.total_fired,
            "restored_checkpoint_id": recov[-1].get("restored_checkpoint_id"),
            "rows": len(got), "rows_equal_uninterrupted": got == want, "seconds": secs,
            "k1_launches": launches, "k1_by_attempt": k1_by_attempt(window_shard)}
    blip["ok"] = bool(st_["status"] == "FINISHED" and st_["restarts"] >= 1
                      and plan.total_fired == 1 and blip["restored_checkpoint_id"] is not None
                      and got == want and launches > 0
                      and every_attempt(window_shard, 1 + st_["restarts"]))
    out["blip"] = blip
    # B2: heartbeat-partition's rule on the window stage's TaskExecutor
    part_spec = spec("api-cluster-ops-partition", sz["delay_partition"])
    with _PipeTap() as pt, K1Tap(lambda: _task_attempt()[0] >= 2) as tap:
        _sync(dev)
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        job = c.client.submit_job(part_spec.to_bytes(), 1)
        first_checkpoint(job, window_shard)
        tm = c.jm._jobs[job].assignment[window_shard]
        first_k1 = k1_by_attempt(window_shard)
        with fault_injection(rules=[{"scope": "heartbeat", "fault": "partition", "match": tm,
                                     "nth": 1, "max_fires": sz["partition_fires"]}]) as plan:
            st_ = c.wait(job)
        secs = time.perf_counter() - t0
        launches = cs.LAUNCHES["k1_superscan"]
        got = cj.fired_rows(c.client.job_result(job) or [])
        exc = c.client.job_exceptions(job)
        k1 = (tap.check("api_cluster_ops leg B: api_ysb's program, the window stage's task of "
                        "the attempt restarted after its TaskExecutor's heartbeat partition, its "
                        "widest dispatch (first_dispatch: its first, over the restored ring as "
                        "loaded)", pt.pipes[-1])
              if cuda and tap.taken is not None else {})
    attributed = [e["exception"] for e in exc["entries"]
                  if e.get("task_manager") == tm and "heartbeat" in e["exception"]]
    recov = exc["recoveries"][-1] if exc.get("recoveries") else {}
    part = {"job": job, "status": st_["status"], "restarts": st_["restarts"],
            "partitioned_task_executor": tm, "window_shard": window_shard,
            "beats_dropped": plan.total_fired, "attributed": attributed,
            "restored_checkpoint_id": recov.get("restored_checkpoint_id"),
            "downtime_ms": recov.get("downtime_ms"), "rows": len(got),
            "rows_equal_uninterrupted": got == want, "seconds": secs,
            "k1_launches": launches, "k1_by_attempt": k1_by_attempt(window_shard),
            "k1_first_attempt_before_partition": first_k1,
            "restarted_dispatch_taken": tap.taken is not None}
    if k1:
        part["k1_cluster_faulted"] = k1
    part["ok"] = bool(st_["status"] == "FINISHED" and st_["restarts"] >= 1
                      and part["restored_checkpoint_id"] is not None and bool(attributed)
                      and got == want and every_attempt(window_shard, 1 + st_["restarts"])
                      and part["restarted_dispatch_taken"] and launches > 0
                      and k1.get("max_abs_err") == 0 and k1["first_dispatch"]["max_abs_err"] == 0)
    out["partition"] = part
    out["ok"] = bool(blip["ok"] and part["ok"])
    return out


def _http(method: str, url: str, body=None):
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _cli(*args) -> tuple:
    """cli.frontend.main(args): (exit code, stdout)."""
    import contextlib
    import io

    from flink_tpu_torch.cli import frontend

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = frontend.main(list(args))
    return rc, buf.getvalue()


APP_SCRIPT = """
from flink_tpu_torch.config import CheckpointingOptions
from flink_tpu_torch.testing import cluster_jobs as cj


def main():
    kw = dict(keys={keys}, batch={batch}, window_ms={window}, slide_ms={slide}, device={dev!r})
    gen = cj.ApiGen({n}, {keys}, delay_s={delay}) if {delay} else None
    env = cj.api_graph({n}, gen=gen, **kw)[0]
    if {interval}:
        env.config.set(CheckpointingOptions.INTERVAL_MS, {interval})
    return env
"""


def ops_leg_c(sz, dev, c, tmp: str, bridged_jobs: dict) -> dict:
    """Leg C: a RestServer over a MiniCluster with cluster `c`'s JobManager
    as its jm_gateway; api_ysb's fused job and a paced checkpointed one
    submitted and operated through the CLI against it; leg B's jobs
    (`bridged_jobs`, name -> id) through the bridge."""
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.runtime.minicluster import MiniCluster
    from flink_tpu_torch.runtime.rest import RestServer

    cluster = MiniCluster()
    server = RestServer(cluster, port=0, jm_gateway=c.client).start()
    url = server.url
    out = {"url_port_nonzero": server.port != 0}

    def script(name, n, delay=0.0, interval=0):
        path = Path(tmp) / f"{name}.py"
        path.write_text(APP_SCRIPT.format(keys=sz["keys"], batch=sz["batch"],
                                          window=sz["window"], slide=sz["slide"], dev=str(dev),
                                          n=n, delay=delay, interval=interval))
        return str(path)

    def get(route):
        status, body = _http("GET", url + route)
        return status, (json.loads(body) if body[:1] in (b"{", b"[") else body)

    try:
        # C1: api_ysb's fused job through POST /jars/run
        n = sz["events_c"]
        with _PlannedPhases() as planned:
            _sync(dev)
            cs.reset_launch_counts()
            t0 = time.perf_counter()
            rc, text = _cli("run", script("ysb", n), "--address", url)
            job = json.loads(text)["jobid"]
            status = cluster.jobs[job].wait(600).value
            _sync(dev)
            secs = time.perf_counter() - t0
            launches = cs.LAUNCHES["k1_superscan"]
        rc_list, listed = _cli("list", "--address", url)
        rc_info, info = _cli("info", job, "--address", url)
        info = json.loads(info)
        _s, prom = get("/metrics")
        dev_status, device = get(f"/jobs/{job}/device")
        ops = list(device.get("operators", {}).values()) if isinstance(device, dict) else []
        phases = ops[0]["phases"] if ops else {}
        programs = (ops[0]["compile"]["programs"] if ops else {})
        dispatches = sum(p["dispatches"] for p in programs.values())
        c1 = {"job": job, "status": status, "cli_rc": [rc, rc_list, rc_info],
              "listed": job in listed, "info_status": info["status"],
              "records_in": info["records_in"], "seconds": secs, "tuples_per_s": n / secs,
              "k1_launches": launches, "device_route": dev_status, "phases": phases,
              "planned": {"fires": planned.fires, "purges": planned.purges},
              "device_dispatches": dispatches,
              "prometheus_has_the_jobs_gauges": (
                  f'job_numRecordsIn{{job="{job}"}} {n}'.encode() in prom
                  and b"# TYPE job_numRecordsIn gauge" in prom
                  and f'job_device_numCompiles{{job="{job}"}}'.encode() in prom)}
        c1["ok"] = bool(status == "FINISHED" and c1["cli_rc"] == [0, 0, 0] and c1["listed"]
                        and c1["info_status"] == "FINISHED" and c1["records_in"] == n
                        and c1["prometheus_has_the_jobs_gauges"] and dev_status == 200
                        and phases.get("ingestRecords") == -(-n // 3)
                        and phases.get("fireSteps") == planned.fires > 0
                        and phases.get("purgeSteps") == planned.purges > 0
                        and dispatches == launches > 0)
        out["ysb"] = c1
        # C2: a paced checkpointed job: checkpoints, exceptions, savepoint,
        # the dashboard and a flame graph while it runs, then cancel
        cs.reset_launch_counts()
        rc, text = _cli("run", script("paced", sz["events_paced"], sz["delay_paced"],
                                      sz["paced_interval_ms"]), "--address", url)
        job2 = json.loads(text)["jobid"]
        client = cluster.jobs[job2]
        deadline = time.monotonic() + 120
        while (client.num_checkpoints < 1 or client.records_in == 0) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        sp_dir = Path(tmp) / "savepoint"
        rc_sp, sp = _cli("savepoint", job2, str(sp_dir), "--address", url)
        sp = json.loads(sp)
        fl_status, flame = get(f"/flamegraph?duration={sz['flame_s']}")
        dash_status, dash = get("/")
        _s, ckpts = get(f"/jobs/{job2}/checkpoints")
        latest = (ckpts.get("latest") or {}).get("completed") or {}
        cid_status, _one = get(f"/jobs/{job2}/checkpoints/{latest.get('id', 0)}")
        exc_status, exc = get(f"/jobs/{job2}/exceptions")
        rc_cancel, cancel = _cli("cancel", job2, "--address", url)
        try:
            final = client.wait(120).value
        except RuntimeError as e:   # a failed job re-raises its error
            final = repr(e)
        c2 = {"job": job2, "cli_rc": [rc, rc_sp, rc_cancel], "savepoint": sp,
              "savepoint_written": sp_dir.exists(), "checkpoints_completed":
              ckpts.get("counts", {}).get("completed"), "checkpoint_route": cid_status,
              "exceptions": exc, "cancel": json.loads(cancel), "final_status": final,
              "k1_launches": cs.LAUNCHES["k1_superscan"],
              "flame_samples": flame.get("samples") if fl_status == 200 else None,
              "dashboard_has_device_table": dash_status == 200 and b"device plane" in dash
              and b"/device" in dash}
        c2["ok"] = bool(c2["cli_rc"] == [0, 0, 0] and bool(sp.get("location"))
                        and c2["savepoint_written"] and (c2["checkpoints_completed"] or 0) >= 1
                        and cid_status == 200 and exc_status == 200
                        and exc.get("root_exception") is None
                        and c2["cancel"] == {"status": "cancelling"} and final == "CANCELED"
                        and (c2["flame_samples"] or 0) > 0
                        and c2["dashboard_has_device_table"] and c2["k1_launches"] > 0)
        out["paced"] = c2
        # C3: leg B's cluster jobs through the bridge
        _s, jobs = get("/jobs")
        ids = {j["id"]: j["status"] for j in jobs["jobs"]}
        bridged = {}
        for name, jb in bridged_jobs.items():
            d_status, detail = get(f"/jobs/{jb}")
            _s, bexc = get(f"/jobs/{jb}/exceptions")
            _s, bck = get(f"/jobs/{jb}/checkpoints")
            d2, bdev = get(f"/jobs/{jb}/device")
            bridged[name] = {"listed": ids.get(jb) == "FINISHED", "detail_status": d_status,
                             "status": detail.get("status"),
                             "num_restarts": detail.get("num_restarts"),
                             "exception_entries": len(bexc.get("entries", [])),
                             "checkpoints_completed": bck.get("counts", {}).get("completed"),
                             "device_route": d2, "device_keys": sorted(bdev)[:8]}
        _s, prom = get("/metrics")
        c3 = {"jobs": bridged, "shard_labels": b'shard="0"' in prom and b'shard="1"' in prom}
        c3["ok"] = bool(c3["shard_labels"] and all(
            b["listed"] and b["detail_status"] == 200 and b["status"] == "FINISHED"
            and (b["checkpoints_completed"] or 0) >= 1 and b["device_route"] == 200
            for b in bridged.values())
            and bridged["partition"]["num_restarts"] >= 1
            and bridged["partition"]["exception_entries"] >= 1)
        out["bridge"] = c3
    finally:
        server.stop()
    out["ok"] = bool(out["ysb"]["ok"] and out["paced"]["ok"] and out["bridge"]["ok"])
    return out


def api_cluster_ops_phase(dev=DEV, sizes=None) -> dict:
    """Phase 33: leg A (the four cluster drills), legs B and C on one
    cluster of three TaskExecutors (leg C's REST server bridges it)."""
    import tempfile

    from flink_tpu_torch.testing.harness import ephemeral_transport_security

    sz = dict(API_CLUSTER_OPS, **(sizes or {}))
    out = {"phase": "api_cluster_ops"}
    t0 = time.perf_counter()
    out["leg_a"] = dict(ops_leg_a(dev), leg_s=time.perf_counter() - t0)
    print(f"api_cluster_ops leg_a: ok={out['leg_a']['ok']} {out['leg_a']['leg_s']:.1f} s",
          file=sys.stderr, flush=True)
    sec = ephemeral_transport_security("api-cluster-ops")
    with tempfile.TemporaryDirectory(prefix="api-cluster-ops-") as tmp, \
            _Cluster(sec, dev, tms=3, tm_kw={"shipping_interval_ms": 100},
                     checkpoint_dir=f"{tmp}/chk", checkpoint_interval=sz["interval_b"],
                     restart_attempts=3, restart_delay=0.2,
                     heartbeat_timeout=sz["heartbeat_timeout_b"], adaptive=False) as c:
        t0 = time.perf_counter()
        out["leg_b"] = dict(ops_leg_b(sz, dev, c), leg_s=time.perf_counter() - t0)
        print(f"api_cluster_ops leg_b: ok={out['leg_b']['ok']} {out['leg_b']['leg_s']:.1f} s",
              file=sys.stderr, flush=True)
        jobs = {name: out["leg_b"][name]["job"] for name in ("blip", "partition")}
        t0 = time.perf_counter()
        out["leg_c"] = dict(ops_leg_c(sz, dev, c, tmp, jobs), leg_s=time.perf_counter() - t0)
        print(f"api_cluster_ops leg_c: ok={out['leg_c']['ok']} {out['leg_c']['leg_s']:.1f} s",
              file=sys.stderr, flush=True)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    out["failed"] = [leg for leg in ("leg_a", "leg_b", "leg_c") if not out[leg]["ok"]]
    out["ok"] = not out["failed"]
    return out


# ---------------------------------------------------------------------------
# phase 34: lint, the port's static analysis over the port as it is installed
# here, in a process of its own
# ---------------------------------------------------------------------------

# `python -m flink_tpu_torch.lint ARGS`, then the device modules the process
# loaded and the analysis time as one JSON line on stderr
_LINT_PROBE = """
import json, runpy, sys, time
sys.argv = ["flink_tpu_torch.lint", *sys.argv[1:]]
t0 = time.perf_counter()
try:
    runpy.run_module("flink_tpu_torch.lint", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
ms = (time.perf_counter() - t0) * 1e3
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "triton", "jax"))
print(json.dumps({"rc": rc, "analysis_ms": ms, "device_modules": loaded[:8],
                  "torch_loaded": "torch" in sys.modules}), file=sys.stderr)
sys.exit(rc)
"""


def lint_phase(dev=DEV) -> dict:
    """Phase 34: `python -m flink_tpu_torch.lint --format json` once, in a
    subprocess, over the installed port with its baseline
    (lint_baseline_torch.json): 16 rules, no active violation, the
    baselined findings, exit code 0, and neither torch nor jax loaded."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _LINT_PROBE, "--format", "json"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    probe = json.loads(res.stderr.strip().splitlines()[-1])
    report = json.loads(res.stdout)
    out = {"phase": "lint",
           "card": card_line() if torch.device(dev).type == "cuda" else "cpu",
           "modules": report["modules_scanned"], "rules": len(report["rules"]),
           "active_violations": len(report["violations"]),
           "baselined": len(report["suppressed"]),
           "baseline_errors": len(report["baseline_errors"]),
           "analysis_ms": probe["analysis_ms"], "process_s": wall_s,
           "exit_code": res.returncode, "torch_loaded": probe["torch_loaded"],
           "device_modules": probe["device_modules"],
           "violations": [f"{v['path']}:{v['line']} {v['rule']}"
                          for v in report["violations"]][:10]}
    out["ok"] = bool(out["rules"] == 16 and out["active_violations"] == 0
                     and out["baseline_errors"] == 0 and out["exit_code"] == 0
                     and not out["torch_loaded"] and not out["device_modules"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels need one",
              file=sys.stderr)
        return 2

    from flink_tpu_torch.api.windowing.assigners import SlidingEventTimeWindows
    from flink_tpu_torch.ops import cuda_session
    from flink_tpu_torch.ops import cuda_superscan as cs
    from flink_tpu_torch.ops.aggregators import count_agg, max_agg, min_agg, sum_agg
    from flink_tpu_torch.ops.superscan import global_superscan_plain, keyed_superscan_plain
    from flink_tpu_torch.runtime.fused_window_pipeline import (
        FusedGlobalWindowPipeline,
        FusedWindowPipeline,
    )
    from flink_tpu_torch.testing import stream as st
    from flink_tpu_torch.testing.timing import cuda_ms, device_split_us

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)

    # ---- 1. device + build (the kernels, and the cold tier's native spill
    # store from native/*.cpp) ----
    from flink_tpu_torch.utils import native_bridge

    t0 = time.perf_counter()
    libs = cs.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spill_store = native_bridge.build()
    native_build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "native_spill_store": str(spill_store.relative_to(native_bridge.BUILD_DIR.parents[2])),
          "native_build_s": native_build_s})

    # ---- 2. K1 against its plain version at the YSB geometry ----
    K, S, NSB, F, R, T, B = (YSB[k] for k in ("K", "S", "NSB", "F", "R", "T", "B"))
    ysb_window = SlidingEventTimeWindows.of(st.WINDOW_MS, st.SLIDE_MS)
    k1_err = 0.0
    for name, agg in (("count", count_agg()), ("sum", sum_agg()),
                      ("max8", max_agg(domain_bits=8))):
        planner = FusedWindowPipeline(ysb_window, agg, key_capacity=K, num_slices=S,
                                      nsb=NSB, fires_per_step=F, out_rows=R,
                                      plan_only=True, device=DEV)
        gen = st.make_device_gen(T, B, device=DEV, with_vals=name != "count", nsb=NSB)
        spans = plan_spans(planner, gen, T, B, st.SLIDE_MS, 2)
        fires = sum(len(p[5]) for _i, _v, p in spans)
        err = compare_kernel(cs.keyed_superscan, keyed_superscan_plain, agg, spans,
                             (S, K), False, NSB=NSB, R=R, spws=(planner.spw,) * F,
                             exact=True)
        k1_err = max(k1_err, err)
        emit({"phase": "k1_vs_plain", "agg": name, "dispatches": len(spans),
              "fires": fires, "max_abs_err": err, "bit_equal": True})
        del spans

    # ---- 3. K2 against its plain version at the Q7 geometry ----
    q7_window = SlidingEventTimeWindows.of(10_000, 10_000)
    k2_err = 0.0
    for name, agg in (("add", sum_agg()), ("min", min_agg()), ("max", max_agg())):
        gpipe = FusedGlobalWindowPipeline(q7_window, agg, num_slices=Q7["S"],
                                          nsb=Q7["NSB"], fires_per_step=Q7["F"],
                                          out_rows=Q7["R"], device=DEV)
        gen = st.make_device_gen(Q7["T"], Q7["B"], device=DEV, slide_ms=10_000,
                                 with_vals=True, nsb=Q7["NSB"])
        spans = plan_spans(gpipe, gen, Q7["T"], Q7["B"], 10_000, 2)
        if name == "add":
            # 0/1 payloads keep every float32 partial sum an exact integer
            spans = [(i, torch.remainder(v, 2), p) for i, v, p in spans]
        err = compare_kernel(cs.global_superscan, global_superscan_plain, agg, spans,
                             (Q7["S"],), True, NSB=Q7["NSB"], R=Q7["R"],
                             spws=(gpipe.planner.spw,) * Q7["F"])
        k2_err = max(k2_err, err)
        emit({"phase": "k2_vs_plain", "agg": name, "dispatches": len(spans),
              "fires": sum(len(p[5]) for _i, _v, p in spans), "max_abs_err": err,
              "bit_equal": True})
        del spans

    # ---- 4/5. the main path (YSB) and the secondary paths, each driven
    # with the launch counts at 0 and checked window by window by replay ----
    wc = WORDCOUNT
    paths = [
        dict(name="ysb_sliding_count", kernel="k1_superscan", agg="count",
             window=st.WINDOW_MS, slide=st.SLIDE_MS, T=T, B=B, spans=YSB["spans"],
             depth=YSB["depth"],
             make=lambda: FusedWindowPipeline(
                 ysb_window, "count", key_capacity=K, num_slices=S, nsb=NSB,
                 fires_per_step=F, out_rows=R, device=DEV),
             gen=st.make_device_gen(T, B, device=DEV, nsb=NSB)),
        dict(name="wordcount_tumbling_count", kernel="k1_superscan", agg="count",
             window=1000, slide=1000, T=wc["T"], B=wc["B"], spans=wc["spans"],
             depth=wc["depth"],
             make=lambda: FusedWindowPipeline(
                 SlidingEventTimeWindows.of(1000, 1000), "count", key_capacity=K,
                 num_slices=S, nsb=NSB, fires_per_step=F, out_rows=R, device=DEV),
             gen=st.make_device_gen(wc["T"], wc["B"], device=DEV, slide_ms=1000,
                                    nsb=NSB)),
        dict(name="q7_global_max", kernel="k2_global_superscan", agg="max",
             window=10_000, slide=10_000, T=Q7["T"], B=Q7["B"], spans=Q7["spans"],
             depth=Q7["depth"],
             make=lambda: FusedGlobalWindowPipeline(
                 q7_window, "max", num_slices=Q7["S"], nsb=Q7["NSB"],
                 fires_per_step=Q7["F"], out_rows=Q7["R"], device=DEV),
             gen=st.make_device_gen(Q7["T"], Q7["B"], device=DEV, slide_ms=10_000,
                                    with_vals=True, nsb=Q7["NSB"])),
    ]
    main_launches, cuda_launches, path_launches = {}, {}, {}
    for p in paths:
        drive(p, spans=1, depth=1)                      # warm-up, uncounted
        cs.reset_launch_counts()
        fired, secs = drive(p)
        launches = cs.LAUNCHES[p["kernel"]]
        per_dispatch = cs.CUDA_LAUNCHES[p["kernel"]] / max(launches, 1)
        main_launches.setdefault(p["kernel"], launches)  # the first path of each kernel
        cuda_launches.setdefault(p["kernel"], per_dispatch)
        path_launches.setdefault(p["kernel"], {})[p["name"]] = launches
        t_rep = time.perf_counter()
        ref = st.replay(p["T"] * p["spans"], p["B"], window_ms=p["window"],
                        slide_ms=p["slide"], agg=p["agg"])
        if p["agg"] == "max":
            # the global max of every non-empty window (an empty one has none)
            expect = {j: np.array([row.max()]) for j, row in ref.fired.items()
                      if np.isfinite(row.max())}
        else:
            expect = ref.fired
        ok, checked = st.parity(expect, fired, require_all=True)
        ok = ok and set(fired) <= set(expect)
        events = p["T"] * p["B"] * p["spans"]
        emit({"phase": p["name"], "tuples_per_s": events / secs, "events": events,
              "seconds": secs, "parity": ok, "windows_checked": checked,
              "kernel": p["kernel"], "launches": launches,
              "cuda_launches_per_dispatch": per_dispatch,
              "replay_s": time.perf_counter() - t_rep})
        if not ok or launches == 0:
            raise AssertionError(f"{p['name']}: parity failed or {p['kernel']} never launched")

    # ---- 6. kernel times at the main paths' shapes ----
    agg = count_agg()
    planner = FusedWindowPipeline(ysb_window, agg, key_capacity=K, num_slices=S, nsb=NSB,
                                  fires_per_step=F, out_rows=R, plan_only=True,
                                  device=DEV)
    idx, _v, plan = plan_spans(planner, paths[0]["gen"], T, B, st.SLIDE_MS, 1)[0]
    count, _ = _fresh_rings(agg, (S, K), DEV, False)
    kw = dict(NSB=NSB, R=R, spws=(planner.spw,) * F, exact=True)
    # with the phase counters on (a job's default) and off, in one call
    k1_timed = on_off_ms(lambda ph: cs.keyed_superscan(agg, count, [], idx, None, plan[:5],
                                                       phase=ph, **kw))
    k1_plain_ms = cuda_ms(lambda: keyed_superscan_plain(agg, count, [], idx, None, plan[:5],
                                                        phase=_phase(), **kw), 2, 3)
    k1_split = device_split_us(
        lambda: cs.keyed_superscan(agg, count, [], idx, None, plan[:5], phase=_phase(), **kw))
    # the other stages of one YSB span: host planning (host clock) and the
    # on-card generator (CUDA events)
    plan_host_ms = []
    for i in range(1, 6):
        t_plan = time.perf_counter()
        planner.plan_superbatch([st.step_bounds(i * T + r, B) for r in range(T)],
                                [st.watermark_after(i * T + r) for r in range(T)])
        plan_host_ms.append((time.perf_counter() - t_plan) * 1e3)
    smin_abs = np.array([st.step_bounds(r, B)[0] for r in range(T)], np.int32)
    ysb_gen_ms = cuda_ms(lambda: paths[0]["gen"](0, smin_abs), 3)
    # yardstick: the ingest alone as one atomic index_add_ of the dispatch's
    # records (what the plain version calls per step); the sort-based
    # index_put_ of earlier runs beside it
    ii = idx.view(T, B).long()
    smin_pos = plan[0].long()[:, None]
    cells = (((smin_pos + ii % NSB) % S) * K + ii // NSB)[ii >= 0]
    ones = torch.ones_like(cells, dtype=torch.int32)
    flat = count.view(-1)
    k1_lib_ms = cuda_ms(lambda: flat.index_add_(0, cells, ones), 10)
    k1_index_put_ms = cuda_ms(lambda: flat.index_put_((cells,), ones, accumulate=True), 10)
    # outputs: the fire rows this dispatch writes (the wrapper's zero fill of
    # the other rows of [R, K] is work the function does not need)
    k1_fires = len(plan[5])
    k1_cost = cs.k1_cost(T=T, B=B, K=K, S=S, F=F, nf=0, fires=k1_fires)
    k1_bound = bound(k1_cost["bytes_accessed"], k1_cost["flops"])
    del ii, cells, ones

    gagg = max_agg()
    gplan_pipe = FusedGlobalWindowPipeline(q7_window, gagg, num_slices=Q7["S"],
                                           nsb=Q7["NSB"], fires_per_step=Q7["F"],
                                           out_rows=Q7["R"], device=DEV)
    gidx, gvals, gplan = plan_spans(gplan_pipe, paths[2]["gen"], Q7["T"], Q7["B"], 10_000, 1)[0]
    gcount, gstates = _fresh_rings(gagg, (Q7["S"],), DEV, True)
    gkw = dict(NSB=Q7["NSB"], R=Q7["R"], spws=(gplan_pipe.planner.spw,) * Q7["F"])
    k2_timed = on_off_ms(lambda ph: cs.global_superscan(gagg, gcount, gstates, gidx, gvals,
                                                        gplan[:5], phase=ph, **gkw))
    k2_plain_ms = cuda_ms(lambda: global_superscan_plain(gagg, gcount, gstates, gidx, gvals,
                                                         gplan[:5], phase=_phase(), **gkw),
                          2, 3)
    k2_split = device_split_us(
        lambda: cs.global_superscan(gagg, gcount, gstates, gidx, gvals, gplan[:5],
                                    phase=_phase(), **gkw))
    gsmin_abs = np.array([st.step_bounds(r, Q7["B"], 10_000)[0] for r in range(Q7["T"])],
                         np.int32)
    q7_gen_ms = cuda_ms(lambda: paths[2]["gen"](0, gsmin_abs), 3)
    gi = gidx.view(Q7["T"], Q7["B"]).long()
    gcols = ((gplan[0].long()[:, None] + gi % Q7["NSB"]) % Q7["S"])[gi >= 0]
    gv = gvals.view(Q7["T"], Q7["B"])[gi >= 0]
    gring = gstates[0]
    k2_lib_ms = cuda_ms(lambda: gring.scatter_reduce_(0, gcols, gv, "amax"), 10)
    k2_cost = cs.k2_cost(T=Q7["T"], B=Q7["B"], S=Q7["S"], F=Q7["F"], nf=1,
                         fires=len(gplan[5]))
    k2_bound = bound(k2_cost["bytes_accessed"], k2_cost["flops"])
    k1_ms, k2_ms = k1_timed["ms"], k2_timed["ms"]
    emit({"phase": "kernel_times", "card": card,
          "k1_ms": k1_ms, "k1_ms_phases_off": k1_timed["ms_phases_off"],
          "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_lib_ms,
          "k1_index_put_ms": k1_index_put_ms, "k1_device_us": k1_split,
          "k2_ms": k2_ms, "k2_ms_phases_off": k2_timed["ms_phases_off"],
          "k2_plain_ms": k2_plain_ms, "k2_library_ms": k2_lib_ms,
          "k2_device_us": k2_split,
          "ysb_span_gen_ms": ysb_gen_ms, "ysb_span_plan_host_ms": float(np.median(plan_host_ms)),
          "q7_span_gen_ms": q7_gen_ms})

    # ---- 8. the DataStream job (this slice's main path), both routes ----
    api = api_ysb_phase()
    emit(api)
    if not api["ok"]:
        raise AssertionError("api_ysb: parity failed, the fused runner was not "
                             "selected, or a route made no K1 dispatch")
    for route in ("fused", "chain"):
        path_launches["k1_superscan"][f"api_ysb_{route}"] = api["timed"][route]["k1_dispatches"]

    # K1 at the main path's shapes: the job's first full fused dispatch
    # (T=32, B=65536, K=8192, R=256), inputs made by the pipeline's staging
    # and prologue; count and the prologue-fed sum
    api_k1 = {name: k1_at_dispatch(f"api_ysb {name}: the DataStream job's first full fused "
                                   "dispatch", *api_k1_inputs(sum_job))
              for name, sum_job in (("count", False), ("sum", True))}
    emit({"phase": "k1_api_shapes", "card": card, **api_k1})

    # ---- 9/10. the session paths (this slice's), each driven with the
    # launch counts at 0 just before it ----
    sess = session_sum_phase()
    emit(sess)
    if not sess["ok"]:
        raise AssertionError(f"session_sum: failed gates {sess['failed']}")
    api_s = api_sessions_phase()
    emit(api_s)
    if not api_s["ok"]:
        raise AssertionError(f"api_sessions: failed gates {api_s['failed']}")
    # ---- 11. K3 and K4 against their plain versions, with their times ----
    skt = session_kernel_times(card)
    emit(skt)
    if skt["failed"]:
        raise AssertionError(f"session_kernel_times: a kernel differs from its plain "
                             f"version: {skt['failed']}")

    # ---- 12-15. the per-batch paths, each with its program calls at 0
    # just before it ----
    late_op = lateness_operator_phase()
    emit(late_op)
    if not late_op["ok"]:
        raise AssertionError("lateness_operator: an emission or the side output differs from "
                             "the oracle, the ingest forms disagree, or the ring is not 64 slices")
    api_late = api_lateness_phase()
    emit(api_late)
    if not api_late["ok"]:
        raise AssertionError("api_lateness: parity failed or TpuWindowOperator was not selected")
    api_count = api_count_window_phase()
    emit(api_count)
    if not api_count["ok"]:
        raise AssertionError("api_count_window: parity failed, TpuGlobalWindowOperator was not "
                             "selected, or its step did not run once a batch")
    api_ga = api_group_agg_phase()
    emit(api_ga)
    if not api_ga["ok"]:
        raise AssertionError("api_group_agg: the device changelog differs from the host path's "
                             "or the device path did not run")
    # ---- 17. the SQL front door (this slice's), its K1 dispatches counted
    # from 0 in each run; then K1 at the SQL job's first full dispatch ----
    t_sql = time.perf_counter()
    api_sql = api_sql_phase()
    api_sql["phase_s"] = time.perf_counter() - t_sql
    emit(api_sql)
    if not api_sql["ok"]:
        raise AssertionError("api_sql: the fused runner was not selected, three-way parity or "
                             "the numpy oracle failed, a route made no K1 dispatch, or the "
                             "row-mode, SESSION or continuous statement differs from its "
                             "reference")
    for route in ("fused", "interpreted"):
        path_launches["k1_superscan"][f"api_sql_{route}"] = api_sql["timed"][route]["k1_dispatches"]
    sql_k1 = k1_at_dispatch("api_sql count: the SQL job's first full fused dispatch",
                            *sql_k1_inputs())
    emit({"phase": "k1_sql_shape", "card": card, **sql_k1})
    # ---- 18. latency mode on the api_ysb program (its K1 launches counted
    # from 0 in each run); K1 at the readback group's shape; C3 on the card
    t_lat = time.perf_counter()
    api_lat = api_latency_phase()
    api_lat["phase_s"] = time.perf_counter() - t_lat
    emit(api_lat)
    if not api_lat["ok"]:
        raise AssertionError("api_latency: a run's rows differ from the throughput run's or "
                             "the numpy oracle's, a full-depth dispatch did not make "
                             "32 / readback-steps K1 launches, or a run launched no K1")
    path_launches["k1_superscan"]["api_latency"] = api_lat["latency"]["k1_launches"]
    *group_in, group_rows = k1_group_inputs(API_LATENCY["readback_steps"])
    grouped_k1 = k1_at_dispatch(
        f"api_latency count: the first readback group of {API_LATENCY['readback_steps']} "
        "steps of the job's first full dispatch", *group_in, R=group_rows)
    emit({"phase": "k1_grouped_shape", "card": card, **grouped_k1})
    c3 = k1_int_sum_phase(card)
    emit(c3)
    if not c3["ok"]:
        raise AssertionError("k1_int_sum: the fused operator's int sum differs from the JAX "
                             "package's rows on ROADMAP C3's inputs, or K1 did not run it")
    # ---- 19. the per-record oracle operator (host code) ----
    t_orc = time.perf_counter()
    api_orc = api_oracle_phase()
    api_orc["phase_s"] = time.perf_counter() - t_orc
    emit(api_orc)
    if not api_orc["ok"]:
        raise AssertionError("api_oracle: a job differs from its numpy model, the oracle was "
                             "not selected, a kernel launched, or the SQL plan report is "
                             "not the JAX package's")
    # ---- 20. shared correlated windows, every run with its K1 launches
    # counted from 0; then K1 at the wide group's shared dispatch (F = 20,
    # mixed spws) and at an unstaged ring (spw 1440, S = 2048) ----
    t_cor = time.perf_counter()
    corr = api_correlated_phase()
    corr["phase_s"] = time.perf_counter() - t_cor
    emit(corr)
    if not corr["ok"]:
        raise AssertionError("api_correlated: a leg's parity failed (shared, independent and "
                             "the numpy model; the wide group's arrays; latency mode's rows), "
                             "the shared runner was not selected, or a run launched no K1")
    for name, runs in (("api_correlated_shared", corr["leg1"]["k1_launches"]["shared"]),
                       ("api_correlated_independent",
                        corr["leg1"]["k1_launches"]["independent"]),
                       ("api_correlated_wide_shared", corr["leg2"]["shared"]["k1_launches"]),
                       ("api_correlated_wide_independent",
                        corr["leg2"]["independent"]["k1_launches"]),
                       ("api_correlated_latency", corr["leg3"]["latency"]["k1_launches"])):
        path_launches["k1_superscan"][name] = runs
    t_k1s = time.perf_counter()
    shared_k1 = k1_at_dispatch(
        "api_correlated wide group: the five-member shared program's first full dispatch "
        "(spws 1/5/15/60/10)", *correlated_k1_inputs(
            DASHBOARD_WIDE, API_CORRELATED["wide_keys"], API_CORRELATED["wide_events"]))
    unstaged_k1 = k1_at_dispatch(
        "api_correlated unstaged ring: 1 min tumbling beside 24 h sliding by 1 min "
        "(spws 1/1440)", *correlated_k1_inputs(
            UNSTAGED, API_CORRELATED["keys"], API_CORRELATED["timed_events"]),
        plain_reps=(1, 1))
    emit({"phase": "k1_shared_shapes", "card": card, "wide": shared_k1,
          "unstaged": unstaged_k1, "phase_s": time.perf_counter() - t_k1s})
    torch.cuda.empty_cache()
    # ---- 21. the million-key state plane: legs A and B through the
    # executor, K1's launches counted from 0 in each run; leg C, the row
    # surface at card width; then K1 at leg B's tiered dispatch ----
    t_tier = time.perf_counter()
    tiered = api_tiered_phase()
    tiered["leg_c"] = tiered_row_surface(card, API_TIERED)
    tiered["ok"] = bool(tiered["ok"] and tiered["leg_c"]["ok"])
    tiered["phase_s"] = time.perf_counter() - t_tier
    emit(tiered)
    if not tiered["ok"]:
        raise AssertionError("api_tiered: a leg's parity failed (the untiered job, the numpy "
                             "oracle), the hot tier outgrew its capacity, nothing was evicted "
                             "or routed cold, the cold tier is not native, a run launched no "
                             "K1, or the row surface differs from its CPU result")
    for label in ("uniform", "zipf"):
        path_launches["k1_superscan"][f"api_tiered_a_{label}"] = \
            tiered["leg_a"][label]["k1_launches"]["tiered"]
        path_launches["k1_superscan"][f"api_tiered_b_{label}"] = \
            tiered["leg_b"][label]["k1_launches"]
    tiered_k1, tiered_k1_zipf = (k1_at_dispatch(
        f"api_tiered count: leg B's {what} ({label} keys, cold records as kid -1)",
        *tiered_k1_inputs(skewed)) for label, skewed, what in (
            ("uniform", False, "first full tiered dispatch"),
            ("zipf", True, "widest tiered dispatch (each eviction flushes)")))
    emit({"phase": "k1_tiered_shape", "card": card, "uniform": tiered_k1,
          "zipf": tiered_k1_zipf})
    torch.cuda.empty_cache()
    # ---- 22. job checkpoints, restart strategies and savepoints through
    # env.execute_async; K1's launches counted from 0 in each run ----
    t_ckpt = time.perf_counter()
    ckpt = api_checkpoint_phase()
    ckpt["card"] = card
    ckpt["phase_s"] = time.perf_counter() - t_ckpt
    emit(ckpt)
    if not ckpt["ok"]:
        raise AssertionError("api_checkpoint: a leg failed a gate (rows of the recovered, "
                             "resumed or tiered job against the uninterrupted run and the "
                             "numpy oracle, one restart from a reported checkpoint, the "
                             "FileSink's committed lines, device memory after the restart, "
                             "checkpoints taken, records_in after the resume, "
                             "incremental_ratio < 0.25) or a run launched no K1")
    leg_a = ckpt["leg_a"]
    k1_checkpoints = {"off": leg_a["off"]["k1_launches"]}
    for interval in API_CHECKPOINT["intervals"]:
        leg = leg_a[f"interval_{interval}ms"]
        if "k1_launches" in leg:
            k1_checkpoints[f"on_{interval}ms"] = leg["k1_launches"]
        k1_checkpoints[f"recovery_{interval}ms"] = leg["recovery"]["k1_launches"]
    path_launches["k1_superscan"].update(
        {f"api_checkpoint_a_{k}": v for k, v in k1_checkpoints.items()})
    path_launches["k1_superscan"]["api_checkpoint_b"] = ckpt["leg_b"]["k1_launches"]
    path_launches["k1_superscan"]["api_checkpoint_b_resumed"] = \
        ckpt["leg_b"]["savepoint"]["k1_launches"]
    path_launches["k1_superscan"]["api_checkpoint_c"] = ckpt["leg_c"]["k1_launches"]
    torch.cuda.empty_cache()
    # ---- 23. two-input joins: legs A-E through the port's API, B5's
    # program calls counted from 0 in each run; then leg B's job once under
    # torch.profiler and once under cProfile ----
    t_join = time.perf_counter()
    api_join = api_join_phase()
    api_join["card"] = card
    api_join["phase_s"] = time.perf_counter() - t_join
    emit(api_join)
    if not api_join["ok"]:
        raise AssertionError("api_join: a leg failed a gate (rows of the device route against "
                             "the host route and the numpy model, the DeviceJoinRunner "
                             "selected with its rings on the card and B5 called, the grown "
                             "zipf ring with no degrade, leg B's geometry and state bytes, "
                             "the SQL routes and refusals, the catalogued degrades, one "
                             "restart from a reported checkpoint with device memory bounded)")
    zb = API_JOIN

    def join_big_run():
        # leg B's job at half its records (the profiles' share per record
        # is the same; the rings reach the same geometry)
        return join_run(join_env(zb["big_events"] // 2, "q8", zb,
                                 keys=zb["big_keys"])[0])["seconds"]

    t_prof = time.perf_counter()
    emit(profile_run("api_join_q8_big", join_big_run,
                     groups=(("index_kernels", "index"), ("copies_dtoh", "Memcpy DtoH"),
                             ("copies_htod", "Memcpy HtoD"))))
    emit(host_profile("api_join_q8_big", join_big_run, top=16))
    emit({"phase": "api_join_profiles", "seconds": time.perf_counter() - t_prof})
    torch.cuda.empty_cache()
    # ---- 16. the per-batch torch programs at these shapes, and the join
    # ring's at leg B's geometry ----
    timed = LATENESS["timed"]
    per_batch = {k: v / timed for k, v in late_op["scatter"]["program_calls"].items()}
    per_batch["ingest_sort"] = late_op["sort"]["program_calls"].get("ingest_sort", 0) / timed
    emit(per_batch_programs(card, per_batch,
                            join=join_programs(api_join["leg_b"]["program_calls"])))

    # ---- 24. the mesh: four virtual shards of the card (legs A-C through
    # the port's API, K1's launches counted from 0 in each run); then K1
    # per shard at leg A's shape, lanes and partials entries ----
    t_mesh = time.perf_counter()
    mesh = api_mesh_phase()
    mesh["card"] = card
    mesh["phase_s"] = time.perf_counter() - t_mesh
    emit(mesh)
    if not mesh["ok"]:
        raise AssertionError("api_mesh: a leg failed a gate (rows of the mesh job, the mesh "
                             "job with local-combine, the one-card job and the numpy model; "
                             "the sharded runner selected with K1 launched once per shard; "
                             "leg B's oracle parity, live rescale and savepoint restores; "
                             "the sharded operator's and the sharded join's rows)")
    t_mk = time.perf_counter()
    from flink_tpu_torch.parallel import mesh as mesh_lib

    real_visible = mesh_lib.visible_devices
    mesh_shards(API_MESH["shards"], DEV)
    try:
        shim, magg, mplan, (midx, mvals) = mesh_k1_inputs(API_MESH, False)
        mesh_k1 = k1_at_dispatch(
            f"api_mesh leg A: shard 0 of {API_MESH['shards']}, its exchanged lanes of the "
            "job's first full dispatch", shim, magg, midx, mvals, mplan)
        del midx, mvals
        shim, magg, mplan, (cpart, parts) = mesh_k1_inputs(API_MESH, True)
        partials_k1 = k1_partials_at(
            f"api_mesh leg A local-combine: shard 0 of {API_MESH['shards']}, its folded "
            "partials of the job's first full dispatch", shim, magg, mplan, cpart, parts)
        del cpart, parts
        lg = mesh["leg_a"]

        def mesh_timed(combine):
            return mesh_run(mesh_job(API_MESH["timed_events"], API_MESH,
                                     shards=API_MESH["shards"], combine=combine,
                                     columnar=True)[0])["seconds"]

        emit({"phase": "k1_mesh_shapes", "card": card, "lanes": mesh_k1,
              "partials": partials_k1})
        emit(mesh_programs(card))
        emit(profile_run("api_mesh_a", lambda: mesh_timed(False),
                         groups=(("k1", "k1_"), ("exchange_where", "where"),
                                 ("exchange_cat", "Cat"), ("copies", "Memcpy"))))
        emit(profile_run("api_mesh_a_combine", lambda: mesh_timed(True),
                         groups=(("k1", "k1_"), ("b4_index_add", "index"),
                                 ("b4_fold", "reduce"), ("exchange_cat", "Cat"))))
        emit(host_profile("api_mesh_a", lambda: mesh_timed(False), top=16))
    finally:
        mesh_lib.visible_devices = real_visible
    emit({"phase": "api_mesh_kernels", "seconds": time.perf_counter() - t_mk})
    torch.cuda.empty_cache()

    # ---- 25. job metrics, latency markers, emission latency, traces,
    # history and the doctor: legs A-C through the port's API, every run
    # with its launch counts at 0 just before it; then the host profile of
    # the job with the defaults, on this thread ----
    t_met = time.perf_counter()
    met = api_metrics_phase()
    met["card"] = card
    met["phase_s"] = time.perf_counter() - t_met
    emit(met)
    if not met["ok"]:
        raise AssertionError("api_metrics: a leg failed a gate (rows against the planes-off "
                             "job and the numpy model, numRecordsIn, marker histograms, the "
                             "emission count against the fires, deviceTimeMsTotal within the "
                             "wall, deviceDispatches against the sections, checkpoint gauges "
                             "and spans, the reports' keys, a family's gauges or emission "
                             "count) or a run launched no K1, K3/K4 or B5")
    emit(host_profile("api_metrics_defaults", lambda: metrics_main_thread_run(API_METRICS),
                      top=16))
    path_launches["k1_superscan"].update({
        "api_metrics_a": met["leg_a"]["k1_launches"],
        "api_metrics_a_planes_off": met["leg_a"]["off_k1_launches"],
        **{f"api_metrics_b_{i}_{r['planes']}": r["k1_launches"]
           for i, r in enumerate(met["leg_b"]["runs"])},
        "api_metrics_c_tiered": met["leg_c"]["tiered"]["launches"]["k1_superscan"],
        "api_metrics_c_latency": met["leg_c"]["latency_mode"]["k1_launches"]})
    torch.cuda.empty_cache()

    # ---- 26. the device plane: legs A-E through the port's API, every run
    # with its launch counts at 0 just before it ----
    t_dev = time.perf_counter()
    devp = api_device_phase()
    devp["card"] = card
    devp["phase_s"] = time.perf_counter() - t_dev
    emit(devp)
    if not devp["ok"]:
        raise AssertionError("api_device: a leg failed a gate (rows against the plane-off job "
                             "and the numpy model, the phase counters against the filter and "
                             "the planner, compiles and their spans, key skew, the roofline "
                             "range, the payload's keys, the cold build, the ring-doubling "
                             "cause, keySkewPerDevice, the mesh's ingest count and K1 once "
                             "per shard, the profiler capture) or a run launched no K1")
    path_launches["k1_superscan"].update({
        "api_device_a": devp["leg_a"]["k1_launches"],
        "api_device_b_ring_doubling": devp["leg_b"]["k1_launches"],
        **{f"api_device_c_{i}_{r['plane']}": r["k1_launches"]
           for i, r in enumerate(devp["leg_c"]["runs"])},
        "api_device_d_card": devp["leg_d"]["card"]["k1"],
        "api_device_d_mesh": devp["leg_d"]["mesh"]["k1"]})
    torch.cuda.empty_cache()

    # ---- 27. the main path's features on the mesh: shared correlated
    # windows, the tiered state plane and queryable state and savepoints
    # over four virtual shards of the card, every run with its launch
    # counts at 0 just before it; then K1 at shard 0's first full shared
    # dispatch of the wide group ----
    t_feat = time.perf_counter()
    feat = api_mesh_features_phase()
    feat["card"] = card
    feat["phase_s"] = time.perf_counter() - t_feat
    emit(feat)
    if not feat["ok"]:
        raise AssertionError("api_mesh_features: a leg failed a gate (leg A: the shared and "
                             "independent mesh jobs, the shared one-card job and the numpy "
                             "model window by window, the shared runner on the mesh, K1 once "
                             "per shard a shared dispatch, the wide group array for array; "
                             "leg B: the tiered mesh job against the untiered one and the "
                             "oracle with evictions and checkpoints, the zipf job's parity, "
                             "residency and cold routing, the sharded row surface against "
                             "the CPU; leg C: the point lookups, the savepoint restored on one "
                             "card and on 2 shards)")
    fa = feat["leg_a"]
    path_launches["k1_superscan"].update({
        **{f"api_mesh_features_a_{name}": rs[0]["k1_launches"]
           for name, rs in fa["timed"].items()},
        "api_mesh_features_a_wide_mesh": fa["wide"]["mesh"]["k1_launches"],
        "api_mesh_features_a_wide_card": fa["wide"]["card"]["k1_launches"],
        "api_mesh_features_b_parity":
            feat["leg_b"]["sharded_parity"]["k1_launches"]["tiered"],
        "api_mesh_features_b_zipf": feat["leg_b"]["zipf"]["k1_launches"],
        "api_mesh_features_c_query": feat["leg_c"]["query"]["k1_launches"]})
    k1_ms_shared = feat["k1_mesh_shared"]
    torch.cuda.empty_cache()

    # ---- 28. the mesh's control loops: the skew rebalancer, the
    # autoscaler's mesh rescale and the device-loss degrade over four
    # virtual shards of the card, every run with its launch counts at 0
    # just before it; then K1's partials entry at shard 0's first full
    # dispatch under the rebalanced table, and the table swap ----
    t_ctl = time.perf_counter()
    ctl = api_mesh_control_phase()
    ctl["phase_s"] = time.perf_counter() - t_ctl
    emit(ctl)
    if not ctl["ok"]:
        raise AssertionError("api_mesh_control: a leg failed a gate (leg A: the runner and "
                             "table selection, the rebalanced mesh job's rows against the "
                             "one-card job and the numpy model, rebalances, the table version, "
                             "no restart, a rebalance recovery, moved groups, the skew below "
                             "the static table's, K1's partials launches; leg B: the executor's "
                             "rejection and 4 -> 2, one rescale onto 2 shards, the gauges, the "
                             "one-card rows; leg C: one restart, 4 -> 2 shards, an injected "
                             "entry, a restored checkpoint, the one-card rows; legs B and C: "
                             "K1's keyed launches)")
    ca = ctl["leg_a"]
    partials_by_path = {
        "api_mesh_control_a_parity": ca["parity"]["k1_partials_mesh"],
        "api_mesh_control_a_uniform": ca["adaptive"]["uniform"]["k1_partials"],
        "api_mesh_control_a_zipf": ca["adaptive"]["zipf"]["k1_partials"]}
    path_launches["k1_superscan"].update({
        "api_mesh_control_a_parity_card": ca["parity"]["k1_card"],
        "api_mesh_control_reference_card": ctl["reference"]["k1"],
        "api_mesh_control_b_autoscale": ctl["leg_b"]["k1"],
        "api_mesh_control_c_degrade": ctl["leg_c"]["k1"]})
    k1_routed = ctl["k1_mesh_routed"]
    torch.cuda.empty_cache()

    # ---- 29. the rest of the DataStream API: a union of two YSB feeds into
    # the fused chain, a map_batch chain and a process() side output into
    # host-keyed windows, the host operators against numpy models and SQL
    # UNION ALL, every run with its launch counts at 0 just before it; then
    # K1 at the union job's first full dispatch, and leg A's union job under
    # torch.profiler and cProfile ----
    t_topo = time.perf_counter()
    topo = api_topologies_phase()
    topo["phase_s"] = time.perf_counter() - t_topo
    emit(topo)
    if not topo["ok"]:
        raise AssertionError("api_topologies: a leg failed a gate (leg A: the fused runner "
                             "after the UnionRunner, the union job's rows against the "
                             "single-source job's and the oracle, K1 launched in every run; "
                             "leg B: both sinks against numpy, the host-keyed fused operators, "
                             "K1 launched; leg C: reduce with query_state, connect, broadcast, "
                             "iterate with its max_rounds guard, async ordered and unordered, "
                             "CEP and API V2 against their models, the coordinator job's one "
                             "restart with its rows and count; leg D: the plan report, the "
                             "rows against the branches alone and numpy, K1 launched)")
    ta = topo["leg_a"]
    topo_launches = {
        "api_topologies_a_union_parity": ta["parity"]["union_k1"],
        "api_topologies_a_single_parity": ta["parity"]["single_k1"],
        **{f"api_topologies_a_{name}_timed_{i}": k
           for name in ("union", "single") for i, k in enumerate(ta["timed"][name]["k1_launches"])},
        "api_topologies_b": topo["leg_b"]["k1_launches"],
        "api_topologies_d": topo["leg_d"]["k1_launches"]}
    path_launches["k1_superscan"].update(topo_launches)
    k1_union = topo["k1_union"]
    emit(profile_run("api_topologies_union", lambda: union_run(
        API_TOPOLOGIES["timed_events"], columnar=True)[1]))
    emit(host_profile("api_topologies_union", lambda: union_run(
        API_TOPOLOGIES["timed_events"], columnar=True)[1]))
    torch.cuda.empty_cache()

    # ---- 30. the chaos plane's drills: the eight in-process scenarios (the
    # mesh ones on four shards of the card), api_ysb's job under an injected
    # device error and under torn checkpoints, api_mesh leg A's job losing a
    # shard, each faulted run against its uninterrupted run, every run with
    # its launch counts at 0 just before it; K1 at the restarted attempt's
    # widest dispatch ----
    t_chaos = time.perf_counter()
    chaos = api_chaos_phase()
    chaos["phase_s"] = time.perf_counter() - t_chaos
    emit(chaos)
    if not chaos["ok"]:
        raise AssertionError("api_chaos: a leg failed a gate (leg 0: every scenario passed, "
                             "none skipped, fired, attributed where the JAX gate asks, the "
                             "mesh 4 -> 2; legs A-C: one restart from a checkpoint with the "
                             "uninterrupted run's rows, the injected attribution, leg B's "
                             "restore behind the torn checkpoints, leg C on 2 shards; K1 "
                             "launched and bit-equal at the restarted dispatch)")
    chaos_launches = {"api_chaos_undisturbed": chaos["undisturbed"]["k1_launches"],
                      "api_chaos_a_device_error": chaos["leg_a"]["k1_launches"],
                      "api_chaos_b_torn": chaos["leg_b"]["k1_launches"],
                      "api_chaos_c_card": chaos["leg_c"]["card_k1_launches"],
                      "api_chaos_c_shard_loss": chaos["leg_c"]["k1_launches"]}
    path_launches["k1_superscan"].update(chaos_launches)
    k1_recovered = chaos["leg_a"]["k1_recovered"]
    torch.cuda.empty_cache()

    # ---- 31. the state tools: a savepoint of api_ysb's tumbling sum job
    # read against numpy, patched sum x 10 and resumed on K1; api_ysb's
    # records through the formatted file sink and source (CSV, JSON lines,
    # Avro) into the fused count job; K1 at the resumed job's widest
    # dispatch over the patched ring ----
    t_tools = time.perf_counter()
    tools = api_state_tools_phase()
    tools["phase_s"] = time.perf_counter() - t_tools
    emit(tools)
    if not tools["ok"]:
        raise AssertionError("api_state_tools: a leg failed a gate (leg A: the reader's cells "
                             "against numpy, the resumed rows and total against the patched "
                             "model, K1 launched and bit-equal over the patched ring; leg B: "
                             "each format's rows against the columnar job's, K1 launched)")
    tools_launches = {"api_state_tools_a_resumed": tools["leg_a"]["k1_launches"],
                      "api_state_tools_b_reference": tools["leg_b"]["reference_k1"],
                      **{f"api_state_tools_b_{f}": tools["leg_b"][f]["k1_launches"]
                         for f in STATE_TOOLS["formats"]}}
    path_launches["k1_superscan"].update(tools_launches)
    k1_patched = tools["leg_a"]["k1_patched"]
    torch.cuda.empty_cache()

    # ---- 32. the cluster: a JobManager and TaskExecutors over the
    # authenticated RPC and columnar data planes, K1 in the TaskExecutor
    # (legs A, B, E), K3/K4 and the per-batch programs in the shards of a
    # sharded job (leg C), ML_PREDICT over a torch model (leg D) ----
    t_cluster = time.perf_counter()
    cluster = api_cluster_phase()
    cluster["phase_s"] = time.perf_counter() - t_cluster
    emit(cluster)
    if not cluster["ok"]:
        raise AssertionError(f"api_cluster: legs {cluster['failed']} failed a gate (leg A: "
                             "rows equal to the local run and the oracle, K1 launched in the "
                             "TaskExecutor and bit-equal; leg B: FINISHED after the "
                             "TaskExecutor loss with the uninterrupted rows, device memory "
                             "within 512 KiB; leg C: equal to numpy with K3/K4 launched; leg "
                             "D: within 1e-5; leg E: the process cluster's rows equal)")
    cluster_launches = {"api_cluster_a_task_executor": cluster["leg_a"]["k1_launches_task_executor"],
                        "api_cluster_a_local": cluster["leg_a"]["k1_launches_local"],
                        "api_cluster_b_first_attempt": cluster["leg_b"]["first_attempt_k1"],
                        "api_cluster_b_restarted": cluster["leg_b"]["k1_launches_restarted"]}
    path_launches["k1_superscan"].update(cluster_launches)
    k1_cluster = cluster["leg_a"]["k1_cluster"]
    torch.cuda.empty_cache()

    # ---- 33. the chaos plane's cluster drills on the card (leg A), two of
    # their fault plans over api_cluster leg B's K1 job (leg B), the REST
    # server, dashboard, flame graph and CLI over K1 jobs and, through its
    # jm_gateway, over leg B's cluster (leg C); K1 at the restarted attempt's
    # widest dispatch after the heartbeat partition ----
    t_ops = time.perf_counter()
    ops = api_cluster_ops_phase()
    ops["phase_s"] = time.perf_counter() - t_ops
    emit(ops)
    if not ops["ok"]:
        raise AssertionError(f"api_cluster_ops: legs {ops['failed']} failed a gate (leg A: the "
                             "four cluster drills passed their JAX gates; leg B: the stage "
                             "edge's blip restarted from a checkpoint, the partitioned window "
                             "stage's TaskExecutor restarted from a checkpoint and attributed, "
                             "the uninterrupted rows, K1 launched in every attempt and "
                             "bit-equal; leg C: the CLI over REST, Prometheus, the device "
                             "route's phase counters and dispatches against K1's, "
                             "checkpoints, savepoint, cancel, dashboard, flame graph, bridge)")
    ob, oc = ops["leg_b"], ops["leg_c"]
    ops_launches = {}
    for run in ("blip", "partition"):
        ops_launches[f"api_cluster_ops_b_{run}"] = ob[run]["k1_launches"]
        for a, v in sorted(ob[run]["k1_by_attempt"].items()):
            ops_launches[f"api_cluster_ops_b_{run}_attempt_{a}"] = v
    ops_launches["api_cluster_ops_c_rest"] = oc["ysb"]["k1_launches"]
    ops_launches["api_cluster_ops_c_paced"] = oc["paced"]["k1_launches"]
    path_launches["k1_superscan"].update(ops_launches)
    k1_faulted = ob["partition"]["k1_cluster_faulted"]
    torch.cuda.empty_cache()

    # ---- 34. the port's static analysis over the installed port, in a
    # process of its own: 16 rules, no active violation, no torch ----
    t_lint = time.perf_counter()
    lint = lint_phase()
    lint["phase_s"] = time.perf_counter() - t_lint
    emit(lint)
    if not lint["ok"]:
        raise AssertionError(f"lint: {lint['active_violations']} active violations "
                             f"{lint['violations']}, {lint['baseline_errors']} baseline errors, "
                             f"exit code {lint['exit_code']}, {lint['rules']} rules, device "
                             f"modules loaded {lint['device_modules']} (want 16 rules, none "
                             "active, exit 0, no torch)")

    kernels = [
        {"name": "k1_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": api_k1["count"]["shape"],
         "launches": api["timed"]["fused"]["k1_dispatches"],
         "launches_by_path": path_launches["k1_superscan"],
         "launches_under_checkpoints": k1_checkpoints,
         "cuda_launches_per_dispatch": cuda_launches["k1_superscan"],
         "max_abs_err": max([k1_err] + [r["max_abs_err"] for r in api_k1.values()]),
         "ms": api_k1["count"]["ms"], "plain_ms": api_k1["count"]["plain_ms"],
         "bound_ms": api_k1["count"]["bound_ms"], "bound_by": api_k1["count"]["bound_by"],
         "library_ms": api_k1["count"]["library_ms"],
         "api_sum": api_k1["sum"],
         "api_sql": dict(sql_k1, launches=api_sql["timed"]["fused"]["k1_dispatches"]),
         "ms_phases_off": api_k1["count"]["ms_phases_off"],
         "ysb_generator": {"shape": f"YSB generator: T={T} B={B} K={K} S={S} R={R}",
                           "fires": k1_fires, "ms": k1_ms,
                           "ms_phases_off": k1_timed["ms_phases_off"], "plain_ms": k1_plain_ms,
                           "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                           "library_ms": k1_lib_ms,
                           "index_put_ms": k1_index_put_ms}},
        {"name": "k1_superscan_grouped", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": grouped_k1["shape"],
         "launches": api_lat["latency"]["k1_launches"],
         "launches_by_path": {"api_latency": api_lat["latency"]["k1_launches"],
                              **{f"api_latency_rung_{r}": v["k1_launches"]
                                 for r, v in api_lat["pinned"].items()}},
         **{k: grouped_k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "device_us", "fires")}},
        {"name": "k1_superscan_shared", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": shared_k1["shape"],
         "launches": corr["leg2"]["shared"]["k1_launches"],
         "launches_by_path": {k: v for k, v in path_launches["k1_superscan"].items()
                              if k.startswith("api_correlated")},
         "max_abs_err": max(shared_k1["max_abs_err"], unstaged_k1["max_abs_err"]),
         **{k: shared_k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "device_us", "fires")},
         "unstaged": unstaged_k1},
        {"name": "k1_superscan_tiered", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": tiered_k1["shape"],
         "launches": tiered["leg_b"]["uniform"]["k1_launches"],
         "max_abs_err": max(tiered_k1["max_abs_err"], tiered_k1_zipf["max_abs_err"]),
         "launches_by_path": {k: v for k, v in path_launches["k1_superscan"].items()
                              if k.startswith("api_tiered")},
         **{k: tiered_k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "device_us", "fires")},
         "zipf": tiered_k1_zipf},
        {"name": "k1_int_sum", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": c3["shape"], "launches": c3["launches"],
         "c3_rows": c3["c3_rows"],
         **{k: c3[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "device_us")}},
        {"name": "k1_mesh_shard", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": mesh_k1["shape"], "launches": lg["mesh_timed"]["k1_launches"],
         "launches_by_path": {f"api_mesh_a_{label}_{run}": lg[label][run]["k1"]
                              for label in ("uniform", "zipf") for run in ("mesh", "card")},
         "k1_per_dispatch_ratio": lg["uniform"]["k1_per_dispatch_ratio"],
         **{k: mesh_k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "device_us", "fires")}},
        {"name": "k1_partials", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": partials_k1["shape"],
         "launches": lg["uniform"]["mesh_combine"]["k1_partials"],
         "launches_by_path": {f"api_mesh_a_{label}_combine":
                              lg[label]["mesh_combine"]["k1_partials"]
                              for label in ("uniform", "zipf")},
         "library": "one index_add_ of the count partial into its ring cells",
         **{k: partials_k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "device_us", "fires")}},
        {"name": "k1_mesh_shared", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_ms_shared["shape"],
         "launches": fa["k1_launches"]["mesh_shared"],
         "launches_by_path": {k: v for k, v in path_launches["k1_superscan"].items()
                              if k.startswith("api_mesh_features")},
         "k1_per_dispatch_ratio": fa["k1_per_shared_dispatch_ratio"],
         **{k: k1_ms_shared[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "device_us",
                                         "fires")}},
        {"name": "k1_mesh_routed", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_routed["shape"],
         "launches": ca["adaptive"]["zipf"]["k1_partials"],
         "launches_by_path": partials_by_path,
         "library": "one index_add_ of the count partial into its ring cells",
         "phase_counts": k1_routed["phase_counts"],
         "routing_swap": ctl.get("routing_swap"),
         **{k: k1_routed[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms", "device_us",
                                      "fires")}},
        {"name": "k1_union", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_union["shape"],
         "launches": ta["timed"]["union"]["k1_launches"][0],
         "launches_by_path": topo_launches,
         **{k: k1_union[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms", "device_us",
                                     "fires")}},
        {"name": "k1_recovered", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_recovered["shape"],
         "launches": chaos["leg_a"]["k1_launches"],
         "launches_by_path": chaos_launches,
         **{k: k1_recovered[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "device_us",
                                         "fires")}},
        {"name": "k1_patched", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_patched["shape"],
         "launches": tools["leg_a"]["k1_launches"],
         "launches_by_path": tools_launches,
         **{k: k1_patched[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms", "device_us",
                                       "fires")}},
        {"name": "k1_cluster", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_cluster["shape"],
         "launches": cluster["leg_a"]["k1_launches_task_executor"],
         "launches_by_path": cluster_launches,
         **{k: k1_cluster[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms", "device_us",
                                       "fires")},
         "first_dispatch": k1_cluster["first_dispatch"]},
        {"name": "k1_cluster_faulted", "route": "cuda",
         "source": "flink_tpu_torch/csrc/superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:103",
         "shape": k1_faulted["shape"],
         "launches": ob["partition"]["k1_launches"],
         "launches_by_path": ops_launches,
         **{k: k1_faulted[k] for k in ("max_abs_err", "ms", "ms_phases_off", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms", "device_us",
                                       "fires")},
         "first_dispatch": k1_faulted["first_dispatch"]},
        {"name": "k2_global_superscan", "route": "cuda",
         "source": "flink_tpu_torch/csrc/global_superscan.cu",
         "replaces": "flink_tpu/ops/pallas_superscan.py:403",
         "shape": f"Q7: T={Q7['T']} B={Q7['B']} S={Q7['S']} R={Q7['R']}",
         "launches": main_launches["k2_global_superscan"],
         "launches_by_path": path_launches["k2_global_superscan"],
         "cuda_launches_per_dispatch": cuda_launches["k2_global_superscan"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "ms_phases_off": k2_timed["ms_phases_off"], "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms},
        {"name": "k3_session_ingest", "route": "cuda",
         "source": "flink_tpu_torch/csrc/session_superscan.cu",
         "replaces": "flink_tpu/ops/superscan.py:510",
         "shape": skt["k3_step"]["shape"], "launches": sess["k3_launches"],
         "launches_by_path": {"session_sum": sess["k3_launches"],
                              "api_sessions": api_s["k3_launches"],
                              "api_metrics_c_session": cuda_session.k3_launches(
                                  met["leg_c"]["session"]["launches"])},
         "routes_by_path": {"session_sum": sess["k3_routes"],
                            "api_sessions": api_s["k3_routes"]},
         "launches_note": "a K3 launch is one wrapper call; a tiled one whose tiles split "
                          "over several clusters runs a second kernel, k3_merge_parts, "
                          "counted under merge_parts",
         "max_abs_err": max(skt[c]["max_abs_err"] for c in ("k3_step", "k3_run", "k3_api_step")),
         **{k: skt["k3_step"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
         "k3_route": skt["k3_step"]["route"],
         "library": "index_add_ x2 + scatter_reduce_ x2 (count, min, max, sum)",
         "run": skt["k3_run"], "api_step": skt["k3_api_step"]},
        {"name": "k4_session_merge", "route": "cuda",
         "source": "flink_tpu_torch/csrc/session_superscan.cu",
         "replaces": "flink_tpu/ops/superscan.py:433",
         "shape": skt["k4_superspan"]["shape"], "launches": sess["k4_launches"],
         "launches_by_path": {"session_sum": sess["k4_launches"],
                              "api_sessions": api_s["k4_launches"],
                              "api_metrics_c_session":
                                  met["leg_c"]["session"]["launches"]["k4_session_merge"]},
         "max_abs_err": max(skt["k4_superspan"]["max_abs_err"],
                            skt["k4_per_watermark"]["max_abs_err"]),
         **{k: skt["k4_superspan"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
         "library": "no single PyTorch call", "per_watermark": skt["k4_per_watermark"]},
    ]
    # ---- 7. where the time goes: each path once more under the profiler ----
    for p in paths:
        emit(profile_path(p))
    emit(profile_run("api_ysb_fused", lambda: api_run(API["fused_events"], True,
                                                      columnar=True)[1]))
    emit(profile_run("api_ysb_chain", lambda: api_run(API["chain_events"], False,
                                                      columnar=True)[1]))
    for route, fused in (("fused", True), ("chain", False)):
        emit(host_profile(f"api_ysb_{route}", lambda f=fused: api_run(
            API["chain_events"], f, columnar=True)[1]))
    sgen = st.make_session_gen(SESSIONS["T"], SESSIONS["B"], device=DEV)
    emit(profile_run("session_sum", lambda: run_sessions(sgen, DEV, SESSIONS,
                                                         SESSIONS["spans"])[1],
                     groups=(("k3", "k3_"), ("k4", "k4_"), ("copies", "Memcpy"))))
    emit(host_profile("api_sessions", lambda: session_api_run(
        API_SESSIONS["events"], API_SESSIONS)[1]))
    # the per-batch paths (lateness_operator's device profile is in its line)
    late_batches = lateness_batches(LATENESS)
    emit(host_profile("lateness_operator", lambda: run_lateness(
        lateness_op(DEV, LATENESS), late_batches, DEV)[1]))
    del late_batches
    emit(profile_run("api_lateness", lambda: api_lateness_run(API_LATENESS), groups=()))
    emit(host_profile("api_lateness", lambda: api_lateness_run(API_LATENESS)))
    # the SQL front door's fused route (phase 17)
    emit(profile_run("api_sql_fused", lambda: sql_counted(
        sql_ysb_job(API_SQL["events"], True, API_SQL)[0])[0]))
    emit(host_profile("api_sql_fused", lambda: sql_counted(
        sql_ysb_job(API_SQL["events"], True, API_SQL)[0])[0]))
    # latency mode (phase 18) and the oracle's SQL statement (phase 19)
    emit(profile_run("api_latency", lambda: latency_run(
        API_LATENCY["events"], True, API_LATENCY)["seconds"]))
    emit(host_profile("api_latency", lambda: latency_run(
        API_LATENCY["events"], True, API_LATENCY)["seconds"]))
    # shared correlated windows (phase 20): leg 1's shared run
    emit(profile_run("api_correlated_shared", lambda: correlated_run(
        API_CORRELATED["timed_events"], True, columnar=True)["seconds"]))
    emit(host_profile("api_correlated_shared", lambda: correlated_run(
        API_CORRELATED["timed_events"], True, columnar=True)["seconds"]))
    # and the wide group at 2^20 keys, shared and independent
    for name, on in (("shared", True), ("independent", False)):
        wide_run = (lambda on=on: correlated_run(
            API_CORRELATED["wide_events"], on, columnar=True, members=DASHBOARD_WIDE,
            keys=API_CORRELATED["wide_keys"])["seconds"])
        if on:
            emit(profile_run(f"api_correlated_wide_{name}", wide_run))
        emit(host_profile(f"api_correlated_wide_{name}", wide_run))
        torch.cuda.empty_cache()
    # the million-key state plane (phase 21): leg B's run, each variant, at
    # an eighth of its records (the profiles' share per record is the same)
    for label, skewed in (("uniform", False), ("zipf", True)):
        run_b = (lambda skewed=skewed: tiered_run(
            API_TIERED["events"] // 8, API_TIERED["keys"], skewed, API_TIERED, tiered=True,
            cap=API_TIERED["hot"])["seconds"])
        emit(profile_run(f"api_tiered_{label}", run_b))
        if skewed:
            emit(host_profile(f"api_tiered_{label}", run_b, top=16))
    # job checkpoints (phase 22): leg A's job with checkpoints at 25 ms,
    # driven on this thread so cProfile sees it
    emit(host_profile("api_checkpoint_25ms", ckpt_main_thread_run, top=16))
    # the chaos drills (phase 30): leg A's faulted job on this thread; the
    # formats (phase 31): leg B's Avro read job
    emit(profile_run("api_chaos_a_device_error", chaos_main_thread_run))
    emit(host_profile("api_chaos_a_device_error", chaos_main_thread_run, top=16))
    emit(profile_run("api_state_tools_b_avro", lambda: format_read_run("avro")))
    emit(host_profile("api_state_tools_b_avro", lambda: format_read_run("avro"), top=16))
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
