"""``cudaMalloc`` calls a build (the caching allocator's
``num_device_alloc`` over the root), from the program's counter."""

from benchmark.spans import root_count


def read(v):
    return root_count(v, "kron.init", "device_allocs")
