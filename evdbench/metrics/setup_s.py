"""setup_s: seconds from the start of the process to the first timed call
(imports, the kernels' build or load, the inputs, the warm call)."""


def read(run):
    return run.setup_s
