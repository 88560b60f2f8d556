"""The error an unported surface raises.

The port carries every surface of the JAX package's modules it mirrors;
what is left raises the error made here, naming where it belongs, instead
of falling back to something else quietly (`config.py`: a configuration
key no option of the port declares)."""

from __future__ import annotations


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an unported option or method raises."""
    return NotImplementedError(f"{what}: not ported yet: ROADMAP.md Queue A, {item}")
