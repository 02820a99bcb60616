"""flat_scan_roofline: the exact flat scan's share of its roofline
(``work/flat_scan.py``) over all the device work of a call."""

from portbench.metrics.roofline import share


def read(ctx):
    return share(ctx, "flat_scan")
