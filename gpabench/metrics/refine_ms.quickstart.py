"""refine_ks's ms an image (lock-ins, exact unwraps, plane fits): CUDA
events around the call, every call of the window."""


def read(run):
    v = [s["refine"] for s in run.stage_ms() if "refine" in s]
    return sum(v) / len(v) if v else None
