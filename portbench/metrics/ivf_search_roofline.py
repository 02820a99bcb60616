"""ivf_search_roofline: the IVF search's share of its roofline
(``work/ivf_search.py``) over all the device work of a call."""

from portbench.metrics.roofline import share


def read(ctx):
    return share(ctx, "ivf_search")
