"""Where the port's unported surfaces are queued.

Every option or method of a ported module that the port does not carry
yet raises the error made here, naming its item in ROADMAP.md's Queue A,
instead of falling back to something else quietly."""

from __future__ import annotations

# the items the errors name (ROADMAP.md, Queue A)
CLUSTER = ("item 14d (the chaos plane's cluster scenarios over the cluster's "
           "seams; then 14e the HTTP planes and 14f the tools)")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an unported option or method raises."""
    return NotImplementedError(f"{what}: not ported yet: ROADMAP.md Queue A, {item}")
