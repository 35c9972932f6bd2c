"""setup_s: seconds from the process start to the window's open: imports,
the card, the sky made and modulated, the warm-up blocks (the kernels'
build or load, each slot's graph captured)."""


def read(run):
    return run.setup_s
