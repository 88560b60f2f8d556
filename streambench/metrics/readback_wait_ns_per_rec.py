"""Host time blocked on the fire rows' copy to the host per record: the
port's `flink.fused.readback_wait` section (`DeferredEmissions.resolve`
waiting on its copy's event) over the window, per record handed over in
the window, in ns (program counter)."""

from streambench.core.sections import section_ns_per_rec


def read(rec):
    return section_ns_per_rec(rec, "flink.fused.readback_wait")
