"""setup_s: seconds from the process's start to the window's: imports, the
kernels' build on a checkout's first run, weights, gallery, warm-up. The
build's (or the library's load's) own share is reported apart in the result
line as `setup_build_s`."""


def read(run):
    return run.setup_s
