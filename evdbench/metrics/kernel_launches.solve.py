"""kernel_launches: the hand-written kernels' CUDA launches over the
window (the port's ``cuda_lib.device_launch_counts``) per call."""


def read(run):
    return sum(run.launches.values()) / run.calls
