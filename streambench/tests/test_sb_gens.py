"""The generator: deterministic per seed, batches cut from the pool, and
YSB's fields at their widths."""

import numpy as np

from streambench.core.spec import load_module
from streambench.tests.tiny import tiny_cell


def make(seed):
    cell, traffic = tiny_cell("ysb.max")
    return load_module("gens", "ysb").make(seed, cell.config, traffic), cell, traffic


def test_same_seed_same_records():
    seed = 2**31 + 12345
    (a, _cell, traffic), (b, *_r), (c, *_s) = make(seed), make(seed), make(seed + 1)
    n = traffic["batch_size"]
    for lo in (0, 3 * n, traffic["pool_records"] - n, 5 * traffic["pool_records"] + n):
        assert np.array_equal(a.batch(lo, n), b.batch(lo, n))
    assert not np.array_equal(a.batch(0, n), c.batch(0, n))
    assert np.array_equal(a.ads, b.ads) and not np.array_equal(a.ads, c.ads)


def test_batches_do_not_depend_on_cutting():
    g, _cell, traffic = make(7)
    n = traffic["batch_size"]
    whole = g.batch(n, 4 * n)
    parts = np.concatenate([g.batch(n + k * n, n) for k in range(4)])
    assert np.array_equal(whole, parts)


def test_ysb_fields_and_table():
    g, cell, traffic = make(3)
    ysb, job = load_module("gens", "ysb"), cell.config["job"]
    assert g.pool.shape == (traffic["pool_records"], 20) and g.pool.dtype == np.int32
    assert g.pool.itemsize * g.pool.shape[1] == 80
    assert np.bincount(g.campaign_of_ad).tolist() == [job["ads_per_campaign"]] * job["campaigns"]
    rows = g.pool.view(np.uint8).reshape(len(g.pool), 80)
    ad = np.ascontiguousarray(rows[:, 32:48]).view("V16").ravel()
    assert set(ad.tolist()) <= set(np.ascontiguousarray(g.ads).view("V16").ravel().tolist())
    for lo, width in ((0, 16), (16, 16), (32, 16)):           # UUID version 4, variant 10
        assert np.all(rows[:, lo + 6] >> 4 == 4) and np.all(rows[:, lo + 8] >> 6 == 2)
    assert len(np.unique(ad)) == 1000 and len(np.unique(rows[:, :16].view("V16"))) == 100
    ad_type = np.ascontiguousarray(rows[:, 48:64]).view("S16").ravel()
    assert set(ad_type.tolist()) == {t.encode() for t in ysb.AD_TYPES}
    event = np.ascontiguousarray(rows[:, 64:72]).view("S8").ravel()
    share = np.asarray([np.mean(event == t.encode()) for t in ysb.EVENT_TYPES])
    assert np.all(np.abs(share - 1 / 3) < 0.01)
    assert set(np.ascontiguousarray(rows[:, 72:80]).view("S8").ravel().tolist()) == {b"1.2.3.4"}


def test_the_first_words_of_the_ad_uuids_differ():
    for seed in range(20):
        g, *_r = make(seed)
        assert len(np.unique(g.ads[:, :4].copy().view("<i4"))) == 1000
