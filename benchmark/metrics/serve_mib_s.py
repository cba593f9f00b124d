"""serve_mib_s: user payload MiB of every op completed inside the window,
over the window's length.  Host clock."""


def read(run):
    w = run.window
    return w["bytes"] / (1 << 20) / w["seconds"]
