"""setup_s: from the process's start to the window's first push: imports,
the kernel library (built on a checkout's first run, then loaded from its
build cache), the input pool, the server and the warm-up."""


def read(run):
    return run.setup_s
