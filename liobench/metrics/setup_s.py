"""Set-up seconds: from the process's start to the window's first scan
(imports, the kernels' libraries, the traffic's lap, the pipeline built and
warmed up, its graph captured, and in a traced run the profiled window)."""


def read(ctx):
    return ctx["setup_s"]
