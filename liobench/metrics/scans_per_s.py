"""Scans a second of one stream: every scan handed over in the window,
over the window's wall time, which ends after the device is drained."""


def read(ctx):
    w = ctx["window"]
    if ctx["driver"] != "replay" or not w["scans"]:
        return None
    return w["scans"] / w["wall_s"]
