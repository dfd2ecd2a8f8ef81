"""peak_mem_mib: torch.cuda.max_memory_allocated over the run, reset after
the input pool was made and before the server was built, read when the
window closes (before the reference runs)."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
