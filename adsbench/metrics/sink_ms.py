"""sink_ms (sink_ms.live): the runner's "sink" stage, the sink's own calls
inside apply, host ms a block: its total over the window's blocks."""


def read(run):
    total, calls = run.stages.get("sink", (0.0, 0))
    if not calls or not run.blocks:
        return None
    return 1e3 * total / run.blocks
