"""Observability: the metric registry (`registry`), task IO ratios and
device timing (`task_io`), spans and their OTLP export (`traces`, `otel`),
emission latency (`emission_latency`), the metric history and the job
doctor (`history`, `doctor`), and checkpoint and failure statistics
(`checkpoint_stats`), and the device plane: compile tracking, cost and
roofline (`device_stats`) and key statistics (`key_stats`), the
cluster's exchange metrics (`exchange`) and on-demand flame graphs from
thread stack sampling (`flamegraph`)."""
