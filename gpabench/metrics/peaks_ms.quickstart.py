"""The peak finder's ms an image: CUDA events around both
extract_primary_ks calls and select_closest_to_triangle, every call of
the window."""


def read(run):
    v = [s["peaks"] for s in run.stage_ms() if "peaks" in s]
    return sum(v) / len(v) if v else None
