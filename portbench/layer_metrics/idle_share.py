"""The share of the traced stretch, from its first device event to its
last, in which the device ran nothing, in percent (averaged over the
cards).  A kernel that spins, as the gate and the peer barriers do while
they wait, counts as busy.  Reads every ``idle_share.<cells>`` metric."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
