"""K1's share of its memory roofline, in %: the least bytes of the run's
data (`roofline/<config>.py`) that the K1 dispatches of the traced part
carry (the run's, times their share of its dispatches), over the published
HBM peak, over the device time of the K1 kernels (`k1_*`) in the capture."""

from streambench.core.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "k1", ("k1_superscan",))
