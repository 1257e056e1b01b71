"""Seconds from process start to the first timed operation."""


def read(run):
    return run.setup_s
