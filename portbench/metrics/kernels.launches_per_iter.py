"""``kernels.launches_per_iter``: every kernel that ran on the device in
the traced solve (the port's passes, PyTorch's step algebra between
them, the bank build and the decisions; copies and fills not counted),
over that solve's loop iterations: fusing the step algebra moves it."""


def read(run):
    t = run.trace
    if t is None or not t.kernel_launches or not t.loop_iterations:
        return None
    return t.kernel_launches / t.loop_iterations
