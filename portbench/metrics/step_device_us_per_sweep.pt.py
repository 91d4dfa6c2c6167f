"""step_device_us_per_sweep.pt: device time a sweep outside the ladder
kernels (the swap features, the int64 sums, the swap step, the samples and
the copies), in us. None without device records."""


def read(view):
    if not view.device or not view.work.get("sweeps"):
        return None
    return sum(e - s for _, s, e in view.other(("ladder_site", "ladder_cluster"))) / view.work["sweeps"]
