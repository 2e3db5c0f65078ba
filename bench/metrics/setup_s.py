"""Seconds from the process's start to the window's: imports, the kernel
build where nothing is built yet, drawing and warming every engine, the
warm backups, and the warm-up requests at the mix's lengths."""


def read(run):
    return run.setup_s
