"""Observability: the metric registry (`registry`), task IO ratios and
device timing (`task_io`), spans and their OTLP export (`traces`, `otel`),
emission latency (`emission_latency`), the metric history and the job
doctor (`history`, `doctor`), and checkpoint and failure statistics
(`checkpoint_stats`). Device and key statistics (`device_stats`,
`key_stats`) come with ROADMAP item D4; the exchange and flame-graph
helpers of the cluster (`exchange`, `flamegraph`) with item 14."""
