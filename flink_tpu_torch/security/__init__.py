"""flink_tpu_torch.security: the part of `flink_tpu/security` the SQL
gateway needs."""

from flink_tpu_torch.security.transport import bearer_header_equal  # noqa: F401
