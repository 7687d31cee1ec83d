"""The multigrid unwrap's ms an image: the factory's "unwrap_coarse" and
"unwrap_v" stages (CUDA events, every call of the window), over the images
of a call."""


def read(run):
    v = [s["unwrap_coarse"] + s["unwrap_v"] for s in run.stage_ms()
         if "unwrap_coarse" in s and "unwrap_v" in s]
    return sum(v) / len(v) / run.batch if v else None
