"""Seconds from the process's start to the window's first visit: imports,
the device and the world, kernel builds and loads, the points' builds,
fills, captures and warm-up, and the calibration rounds."""


def read(run):
    return run.setup_s
