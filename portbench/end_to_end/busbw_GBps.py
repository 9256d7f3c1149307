"""Bus bandwidth over the whole window: every execution the window
completed, its bytes times the op's nccl-tests bus factor, over the
window's wall seconds (the slowest rank's).  Reads ``busbw_GBps.cards``
too, the same quantity across cards, kept apart for its own bound."""

from portbench import arith


def read(run):
    return arith.window_busbw(run.visits, run.ranks, run.window_s)
