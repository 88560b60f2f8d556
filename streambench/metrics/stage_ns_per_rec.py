"""Host time filling the fused route's staging per record: the port's
`flink.fused.stage` section (a dispatch's record columns copied into its
staging buffers on the host, the uploads left out) over the window, per
record handed over in the window, in ns (program counter)."""

from streambench.core.sections import section_ns_per_rec


def read(rec):
    return section_ns_per_rec(rec, "flink.fused.stage")
