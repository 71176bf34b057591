"""setup_s: seconds from the process's start to the first instant of the
window (building or loading the kernels, making the weights, building the
engine and capturing its graphs, warming up the cell's shapes)."""


def read(run):
    return run.setup_s
