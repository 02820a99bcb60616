"""binary_search_roofline: the two-stage binary search's share of its
roofline (``work/binary_search.py``) over all the device work of a call."""

from portbench.metrics.roofline import share


def read(ctx):
    return share(ctx, "binary_search")
