"""Command-line client (reference: flink-clients CliFrontend.java:93);
counterpart of `flink_tpu/cli`."""

from flink_tpu_torch.cli.frontend import main
