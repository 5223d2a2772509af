"""Device time per statistics build of the profiled builds (the union of
the device's operation intervals)."""


def read(v):
    busy = v.device_s()
    return 1e3 * busy / v.items if busy and v.items else None
