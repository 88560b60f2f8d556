"""Config reference generation (X1 analogue).

Counterpart of `flink_tpu/docs/generate.py`, over the port's options: walk
the option-holder classes of `flink_tpu_torch/config.py` and emit the
markdown reference table, the JAX package's rows and columns.
`python -m flink_tpu_torch.docs.generate [OUT]` writes it to OUT
(default `docs/configuration_torch.md`; the JAX package's generator owns
`docs/configuration.md`).
"""

from __future__ import annotations

import inspect
import os
from typing import List, Tuple

from flink_tpu_torch import config as config_module
from flink_tpu_torch.config import ConfigOption


def collect_options() -> List[Tuple[str, str, ConfigOption]]:
    """(holder_class, attribute, option) for every declared ConfigOption."""
    out = []
    for cls_name, cls in inspect.getmembers(config_module, inspect.isclass):
        if not cls_name.endswith("Options") or cls_name == "ConfigOptions":
            continue
        for attr, val in vars(cls).items():
            if isinstance(val, ConfigOption):
                out.append((cls_name, attr, val))
    return sorted(out, key=lambda t: t[2].key)


def render_markdown() -> str:
    lines = [
        "# Configuration reference",
        "",
        "Generated by `python -m flink_tpu_torch.docs.generate` from the",
        "`ConfigOption` holders in `flink_tpu_torch/config.py`",
        "(the reference generates its docs the same way, flink-docs).",
        "",
        "| Key | Default | Type | Holder | Description |",
        "|-----|---------|------|--------|-------------|",
    ]
    for cls_name, attr, opt in collect_options():
        typ = getattr(opt.type, "__name__", str(opt.type))
        default = "(none)" if opt.default is None else repr(opt.default)
        desc = " ".join(opt.description.split()).replace("|", "\\|")
        lines.append(
            f"| `{opt.key}` | {default} | {typ} | `{cls_name}.{attr}` | {desc} |"
        )
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = argv[0] if argv else os.path.join(repo_root, "docs", "configuration_torch.md")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(render_markdown())
    print(f"wrote {out} ({len(collect_options())} options)")


if __name__ == "__main__":
    main()
