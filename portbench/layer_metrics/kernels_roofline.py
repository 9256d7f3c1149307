"""The traced executions' least time (each op's own byte count at its
size over the card's data-sheet rates, per op and size, never per kernel
name) over the device's busy time in the traced stretch, in percent.
Reads every ``kernels_roofline.<cells>`` metric."""

from portbench import arith


def read(run):
    if run.trace is None or not run.traced:
        return None
    return arith.roofline_share(run.traced, run.ranks, run.across_cards,
                                run.trace.busy_s)
