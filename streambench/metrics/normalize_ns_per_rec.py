"""Host time in the fused operator's step normalizer per record: the port's
`flink.fused.normalize` section (`StepNormalizer.push` of each batch and
`advance` of each watermark) over the window, per record handed over in the
window, in ns (program counter)."""

from streambench.core.sections import section_ns_per_rec


def read(rec):
    return section_ns_per_rec(rec, "flink.fused.normalize")
