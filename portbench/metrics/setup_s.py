"""setup_s: seconds from the start of the process to the window's start
(loading and building, the inputs, the warm-up steps)."""


def read(run):
    return run.setup_s
