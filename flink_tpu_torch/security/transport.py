"""Bearer-token check of the HTTP planes.

The part of `flink_tpu/security/transport.py` the port carries (:273,
jax-free there): the comparison the SQL gateway makes of a request's
Authorization header. The rest of the transport security layer (TLS,
cluster secrets, HMAC channels) comes with the control plane (ROADMAP.md
Queue A, item 14).
"""

from __future__ import annotations

import hmac


def bearer_header_equal(header_value: str, token: str) -> bool:
    """Constant-time check of an Authorization header against
    `Bearer <token>`. Compares latin-1 BYTES: compare_digest raises
    TypeError on non-ASCII str input, and http.server decodes headers as
    latin-1, so a garbage header must read as unauthorized, never kill the
    handler thread."""
    return hmac.compare_digest(
        (header_value or "").encode("latin-1", "replace"),
        f"Bearer {token}".encode("latin-1", "replace"),
    )
