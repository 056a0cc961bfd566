"""device_idle_share.caption: the share of the traced window in which no
operation ran on the card, in %, captioning cells."""

from portbench.common import readers as R


def read(rec, ctx):
    if rec.get("kind") != "caption":
        return None
    busy, win = R.busy_s(rec), R.window_s(rec)
    if busy is None or not win:
        return None
    return 100.0 * (1.0 - busy / win)
