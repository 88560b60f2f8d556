"""Plain numpy reference of the YSB job: views counted per campaign over
tumbling event-time windows, from the generator's pool and the number of
records handed over. It imports nothing of the port.

A record is a view where its event_type bytes read "view"; its campaign
is the table's campaign of the ad whose 16 UUID bytes equal the record's
(a record whose ad is not in the table counts nowhere). Record i has
event time t0 + (i * 1000) // rate, so the records of window j (event
time [j * size, (j + 1) * size)) are an index range, found in closed
form. Per campaign, the views in records [0, x) are F(x): whole pool
cycles, a prefix table every G pool rows, and a bincount of the rest. A
row is (campaign, window end - 1, count) for every window and campaign
with a view, as the job emits them once its final watermark has passed
every window.

`precision="float16"` is the control: every count held in a 16-bit float
(each window's sum of its blocks accumulated in float16).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

G = 1 << 16


def view_campaigns(gen, cfg: dict) -> np.ndarray:
    """Per pool row: the campaign of a view, -1 for other events."""
    from streambench.core.spec import load_module

    cols = load_module("gens", "ysb")
    pool = gen.pool
    event = np.ascontiguousarray(pool[:, cols.EVENT_TYPE:cols.EVENT_TYPE + 2]).view("S8").ravel()
    ad = np.ascontiguousarray(pool[:, cols.AD:cols.AD + 4]).view("V16").ravel()
    table = np.ascontiguousarray(gen.ads).view("V16").ravel()
    order = np.argsort(table)
    i = np.minimum(np.searchsorted(table[order], ad), len(table) - 1)
    found = table[order][i] == ad
    camp = np.where(found, gen.campaign_of_ad[order][i], -1)
    return np.where(event == cfg["job"]["view_event_type"].encode("ascii"), camp, -1)


class ViewCounter:
    """F(x): views per campaign among records [0, x)."""

    def __init__(self, vc: np.ndarray, campaigns: int):
        self.vc, self.C, self.P = vc, campaigns, len(vc)
        blocks = -(-self.P // G)
        prefix = np.zeros((blocks + 1, campaigns), np.int64)
        for m in range(blocks):
            prefix[m + 1] = prefix[m] + self._bins(vc[m * G:(m + 1) * G])
        self.prefix, self.total = prefix, prefix[-1]

    def _bins(self, v: np.ndarray) -> np.ndarray:
        return np.bincount(v + 1, minlength=self.C + 1)[1:].astype(np.int64)

    def __call__(self, x: int) -> np.ndarray:
        q, r = divmod(int(x), self.P)
        m = r // G
        return q * self.total + self.prefix[m] + self._bins(self.vc[m * G:r])


def expected(gen, cfg: dict, n: int, precision: str = "exact"
             ) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], Dict[str, int]]:
    """((campaigns, row timestamps, counts), data counts) of the job over
    records 0 .. n-1."""
    job = cfg["job"]
    rate, t0 = int(cfg["event_rate_per_s"]), int(job["t0_ms"])
    size, C = int(job["window_ms"]), int(job["campaigns"])
    F = ViewCounter(view_campaigns(gen, cfg), C)
    last_ts = t0 + ((n - 1) * 1000) // rate
    j0, j1 = t0 // size, last_ts // size

    def first_index(t_ms: int) -> int:        # first record with event time >= t_ms
        return min(max(-(-(t_ms - t0) * rate // 1000), 0), n)

    bounds = [first_index(j * size) for j in range(j0, j1 + 2)]
    exact = np.diff(np.stack([F(x) for x in bounds]), axis=0)        # [j1 - j0 + 1, C]
    if precision == "float16":
        # a window's count summed in 16-bit floats, block by block
        win = np.zeros(exact.shape, np.float16)
        for k in range(len(win)):
            a, b = bounds[k], bounds[k + 1]
            edges = [a] + list(range((a // G + 1) * G, b, G)) + [b]
            for x, y in zip(edges[:-1], edges[1:]):
                win[k] = np.add(win[k], (F(y) - F(x)).astype(np.float16), dtype=np.float16)
    elif precision == "exact":
        win = exact
    else:
        raise ValueError(precision)
    k, camp = np.nonzero(win > 0)
    ends = (j0 + k + 1) * size
    counts = win[k, camp].astype(np.float64)
    data = {"records": int(n), "aggregated_records": int(exact.sum()),
            "result_cells": int(np.count_nonzero(exact))}
    return (camp.astype(np.int64), (ends - 1).astype(np.int64), counts), data
