"""stream_msps: samples the window handed the runner, over the seconds
from the window's open until the runner returned with each decoded and
applied, in millions."""


def read(run):
    return run.samples / run.window_s / 1e6 if run.samples else None
