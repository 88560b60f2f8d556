"""The reference against a per-record brute force at a tiny size, and the
control (16-bit counts) against the reference."""

import numpy as np
import pytest

from streambench.core.check import compare_rows
from streambench.core.feed import event_times
from streambench.core.spec import load_module
from streambench.tests.tiny import tiny_cell


def brute_ysb(gen, cfg, n):
    """Every view's (campaign, window) by Flink's tumbling assignment, the
    ad found by comparing its 16 UUID bytes with each ad's."""
    j = cfg["job"]
    size = j["window_ms"]
    ads = {bytes(a): int(c) for a, c in zip(gen.ads, gen.campaign_of_ad)}
    ts = event_times(0, n, j["t0_ms"], cfg["event_rate_per_s"])
    rec = gen.batch(0, n)
    counts = {}
    for r, t in zip(rec, ts.tolist()):
        raw = r.tobytes()
        if raw[64:72].rstrip(b"\0") != b"view":
            continue
        key = (ads[raw[32:48]], t - t % size + size - 1)
        counts[key] = counts.get(key, 0) + 1
    return counts


def as_rows(d):
    keys = np.asarray([k for k, _t in d], np.int64)
    ts = np.asarray([t for _k, t in d], np.int64)
    return keys, ts, np.asarray(list(d.values()), np.float64)


@pytest.mark.parametrize("seed,n", [(2**33 + 5, 500_000), (7, 262_144)])
def test_reference_is_the_brute_force(seed, n):
    cell, traffic = tiny_cell("ysb.max")
    gen = load_module("gens", cell.config_name).make(seed, cell.config, traffic)
    want, data = load_module("reference", cell.config_name).expected(gen, cell.config, n)
    got = brute_ysb(gen, cell.config, n)
    assert len({t for _k, t in got}) >= 2
    assert compare_rows(as_rows(got), want) == {
        "rows_missing": 0, "rows_extra": 0, "rows_duplicated": 0, "result_mismatch": 0}
    assert data["result_cells"] == len(got) and data["records"] == n
    assert data["aggregated_records"] == sum(got.values())


def test_a_record_whose_ad_is_not_in_the_table_counts_nowhere():
    cell, traffic = tiny_cell("ysb.max")
    ref = load_module("reference", "ysb")
    gen = load_module("gens", "ysb").make(3, cell.config, traffic)
    base = ref.view_campaigns(gen, cell.config)
    gen.ads = gen.ads.copy()
    gen.ads[5, 15] ^= 1                       # one byte of one ad's UUID
    vc = ref.view_campaigns(gen, cell.config)
    lost = gen.pool[:, 8:12].view("V16").ravel() == gen.ads[5:6].copy().view("V16")[0]
    assert not lost.any()
    changed = vc != base
    assert changed.any() and np.all(vc[changed] == -1)


def test_the_control_fails():
    """Counts in the tens of thousands: a 16-bit float holds them only to
    2048, and none past 65504."""
    cell, traffic = tiny_cell("ysb.max", rate=1_000_000)
    gen = load_module("gens", cell.config_name).make(9, cell.config, traffic)
    ref = load_module("reference", cell.config_name)
    n = 30_000_000
    want, _ = ref.expected(gen, cell.config, n)
    ctl, _ = ref.expected(gen, cell.config, n, precision="float16")
    assert want[2].max() > 2048
    assert compare_rows(ctl, want)["result_mismatch"] > 0
