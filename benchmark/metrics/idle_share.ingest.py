"""The device's idle share over the profiled part of the window: one minus
the union of its operation intervals over the window's length."""


def read(v):
    return v.idle_share()
