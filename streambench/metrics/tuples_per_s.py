"""Input records consumed per second: every record the source handed over
in the window, over the window's wall time from its first batch to the job
closing its sink (the drain included). Host clock."""


def read(rec):
    return rec["window_records"] / rec["window_s"]
