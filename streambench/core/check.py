"""The comparison that decides `correct`: result rows against the
reference's, one by one.

A row is (key, timestamp, result), the timestamp being its window's end
less 1 (the job's emission timestamp). Each number compared has a limit
of 0: the configurations state exact results, every row delivered once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LIMITS = {"rows_missing": 0, "rows_extra": 0, "rows_duplicated": 0, "result_mismatch": 0}


def compare_rows(got: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 want: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> Dict[str, int]:
    """Numbers of rows the reference has and the run lacks, rows the run
    has and the reference lacks, rows the run delivered more than once,
    and rows whose result differs. `got` and `want` are (keys, ts,
    results)."""
    gk, gt, gr = (np.asarray(a) for a in got)
    wk, wt, wr = (np.asarray(a) for a in want)
    order = np.lexsort((gt, gk))
    gk, gt, gr = gk[order], gt[order], gr[order]
    dup = np.zeros(len(gk), bool)
    if len(gk) > 1:
        dup[1:] = (gk[1:] == gk[:-1]) & (gt[1:] == gt[:-1])
    gk, gt, gr = gk[~dup], gt[~dup], gr[~dup]
    keys = np.concatenate([wk, gk]).astype(np.int64)
    ts = np.concatenate([wt, gt]).astype(np.int64)
    res = np.concatenate([wr, gr]).astype(np.float64)
    side = np.concatenate([np.zeros(len(wk), np.int8), np.ones(len(gk), np.int8)])
    order = np.lexsort((side, ts, keys))
    keys, ts, res, side = keys[order], ts[order], res[order], side[order]
    pair = np.zeros(len(keys), bool)     # i and i + 1 are the same row, want then got
    if len(keys) > 1:
        pair[:-1] = (keys[1:] == keys[:-1]) & (ts[1:] == ts[:-1]) & (side[:-1] == 0)
    matched = int(pair.sum())
    i = np.flatnonzero(pair)
    return {"rows_missing": len(wk) - matched, "rows_extra": len(gk) - matched,
            "rows_duplicated": int(dup.sum()),
            "result_mismatch": int(np.sum(res[i] != res[i + 1]))}


def verdict(numbers: Dict[str, int]) -> Tuple[bool, List[Tuple[str, int, int]]]:
    """(correct, [(name, number, limit)])."""
    rows = [(k, int(numbers[k]), LIMITS[k]) for k in LIMITS]
    return all(v <= lim for _k, v, lim in rows), rows
