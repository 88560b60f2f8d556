"""The 95th percentile, over every result row due in the window, of the
time from the source handing over the batch whose watermark first passes
the row's timestamp (its window's end less 1) to the sink receiving the
row. Rows that only the end of input makes due (the drain's) are left
out: a stream that runs on has no such rows. In ms, host clock."""

import numpy as np


def read(rec):
    rows = rec["rows"]
    wm = np.maximum.accumulate(np.asarray(rec["hand_wm"], np.int64))
    t_hand = np.asarray(rec["hand_t"], np.float64)
    i = np.searchsorted(wm, rows["ts"], side="left")
    keep = i < len(wm)
    due = t_hand[i[keep]]
    lag = rows["arrival"][keep] - due
    lag = lag[due >= rec["t_open"]]
    if not len(lag):
        return None
    return float(np.percentile(1000.0 * lag, 95))
