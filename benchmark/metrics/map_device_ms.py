"""Device time per request of the profiled requests (the union of the
device's operation intervals)."""


def read(v):
    busy = v.device_s()
    return 1e3 * busy / v.items if busy and v.items else None
