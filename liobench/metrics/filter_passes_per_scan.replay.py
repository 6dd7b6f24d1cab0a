"""Control flow and iterated update: the filter's passes a scan
(``StepDiag.iterations``, read after the window's drain)."""


def read(ctx):
    p = ctx["window"].get("passes")
    if ctx["driver"] != "replay" or not p:
        return None
    return sum(p) / len(p)
