"""``peak_gib.*``: the device memory the program holds for the window's
work at its peak, in GiB: ``torch.cuda.max_memory_reserved()`` after
``reset_peak_memory_stats()`` at the window's start, less the bytes of the
benchmark's own inputs on the device (the training pool). Reserved, not
allocated: a replayed CUDA graph allocates nothing, and its activations live
in the graph's private pool, which is reserved. It includes the blocks the
caching allocator keeps for reuse."""


def read(m):
    return m.peak_bytes / 2**30 if m.peak_bytes else None
