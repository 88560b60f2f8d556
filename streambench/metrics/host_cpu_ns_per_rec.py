"""Host CPU time per record of the runners and the job runtime: the
process's CPU time (`time.process_time`) over the window, less the
source's own thread CPU time, per record handed over in the window, in
ns."""


def read(rec):
    n = rec["window_records"]
    if not n:
        return None
    return 1e9 * (rec["proc_cpu_s"] - rec["source_cpu_s"]) / n
