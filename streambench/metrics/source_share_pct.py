"""The load generator's share of the window: the benchmark's source's own
time inside its polls (cutting a batch from the pool, stamping its event
time), over the window's wall time, in %."""


def read(rec):
    return 100.0 * rec["source_wall_s"] / rec["window_s"]
