"""peak_mem_gb (GB): ``torch.cuda.max_memory_allocated()`` over the
window, in 1e9 bytes."""


def read(rec):
    if rec.peak_bytes <= 0:
        return None
    return rec.peak_bytes / 1e9
