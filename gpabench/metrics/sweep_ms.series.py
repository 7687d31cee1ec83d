"""The grouped sweep's ms an image: the factory's "sweep" stage (CUDA
events around the stage inside run, every call of the window), over the
images of a call."""


def read(run):
    v = [s["sweep"] for s in run.stage_ms() if "sweep" in s]
    return sum(v) / len(v) / run.batch if v else None
