"""Authenticated, pickle-free transport for the runtime's network planes.

- `framing`: restricted (allowlisted) deserialization + per-frame HMACs.
- `transport`: cluster secret resolution, connection handshake, TLS.

See the module docstrings for the threat model; runtime/rpc.py,
runtime/dataplane.py, and runtime/rest.py are the integration points.

Counterpart of `flink_tpu/security/__init__.py`: the same exports.
"""

from flink_tpu_torch.security.framing import (
    FrameAuthError,
    FrameCodec,
    RestrictedUnpicklingError,
    restricted_loads,
    trusted_loads,
)
from flink_tpu_torch.security.transport import (
    SecurityConfig,
    bearer_header_equal,
    rest_bearer_token,
)

__all__ = [
    "FrameAuthError",
    "FrameCodec",
    "RestrictedUnpicklingError",
    "SecurityConfig",
    "bearer_header_equal",
    "rest_bearer_token",
    "restricted_loads",
    "trusted_loads",
]
