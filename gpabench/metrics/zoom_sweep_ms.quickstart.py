"""The zoom sweep's ms an image: the eager extract_displacement_field's
"sweeps" stage (CUDA events, every call of the window)."""


def read(run):
    v = [s["sweeps"] for s in run.stage_ms() if "sweeps" in s]
    return sum(v) / len(v) if v else None
