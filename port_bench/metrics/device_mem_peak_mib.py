"""device_mem_peak_mib: torch.cuda.max_memory_reserved() over the run up
to the window's end (graph pools included), MiB."""


def read(run):
    return run.memory_peak_bytes / 2**20 if run.memory_peak_bytes else None
