"""step_ops_per_sweep.pt: device operations (kernels, copies, sets) a sweep
outside the ladder kernels, as recorded. None without device records."""


def read(view):
    if not view.device or not view.work.get("sweeps"):
        return None
    return len(view.other(("ladder_site", "ladder_cluster"))) / view.work["sweeps"]
