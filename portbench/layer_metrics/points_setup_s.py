"""Host seconds spent building, filling and warming the cell's points
(the slowest rank's): the port's builds, captures and warm runs."""


def read(run):
    return run.points_setup_s
