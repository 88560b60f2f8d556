"""The YSB advertising job through the port's public DataStream API:
views only, ad -> campaign through the static table (YSB's Redis join),
count per campaign over tumbling event-time windows. Both selectors are
traceable, so the planner fuses them into the device chain ahead of K1.

The filter compares the event_type field's 8 bytes with "view"'s. The key
selector finds the ad by the first word of its UUID in the sorted table
and keeps the record only where all 16 bytes match (else key -1, which
the chain drops); the key is the campaign's number in the table."""

from __future__ import annotations

import numpy as np
import torch

from flink_tpu_torch.api.windowing.assigners import TumblingEventTimeWindows
from flink_tpu_torch.core.watermarks import WatermarkStrategy


def build(env, source, sink, cfg: dict, gen) -> None:
    from streambench.core.spec import load_module

    cols = load_module("gens", "ysb")
    job = cfg["job"]
    view = [int(w) for w in cols.words(job["view_event_type"], 8)]
    ad_words = gen.ads.view("<i4")                      # [ads, 4]
    order = np.argsort(ad_words[:, 0], kind="stable")
    tables = {}

    def is_view(col):
        return (col[:, cols.EVENT_TYPE] == view[0]) & (col[:, cols.EVENT_TYPE + 1] == view[1])

    def campaign(col):
        t = tables.get(col.device)
        if t is None:
            t = tables[col.device] = (
                torch.as_tensor(np.ascontiguousarray(ad_words[order, 0]), device=col.device),
                torch.as_tensor(np.ascontiguousarray(ad_words[order]), device=col.device),
                torch.as_tensor(gen.campaign_of_ad[order].astype(np.int64), device=col.device))
        first, whole, camp = t
        ad = col[:, cols.AD:cols.AD + 4]
        # pad rows of the fused chain hold uninitialized words: the clamp
        # keeps every row's index inside the table
        i = torch.searchsorted(first, ad[:, 0].contiguous()).clamp_(max=len(first) - 1)
        hit = (whole[i] == ad).all(dim=1)
        return torch.where(hit, camp[i], -1)

    (env.from_source(source, WatermarkStrategy.for_bounded_out_of_orderness(
        job["watermark_bound_ms"]))
     .filter(is_view, traceable=True)
     .key_by(campaign, traceable=True)
     .window(TumblingEventTimeWindows.of(job["window_ms"]))
     .aggregate("count")
     .sink_to(sink))
