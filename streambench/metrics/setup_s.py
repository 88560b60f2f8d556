"""Set-up: from the process's start to the window's first batch (imports,
CUDA, the record pool, the job's build and start, the warm-up). Host
clock."""


def read(rec):
    return rec["setup_s"]
