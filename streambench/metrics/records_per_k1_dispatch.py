"""Records handed over in the window per K1 dispatch in it
(`cuda_superscan.LAUNCHES["k1_superscan"]`, counted from the window's
first batch to the end of the drain). None when K1 did not launch."""


def read(rec):
    k1 = rec["launches"].get("k1_superscan", 0)
    return rec["window_records"] / k1 if k1 else None
