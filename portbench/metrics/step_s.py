"""step_s: the window's seconds over the steps completed in it."""


def read(run):
    return run.window_s / run.steps if run.steps else None
