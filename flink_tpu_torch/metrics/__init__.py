"""Observability: checkpoint and failure statistics (`checkpoint_stats`). The
metric registry, traces and history come with ROADMAP item 15."""
