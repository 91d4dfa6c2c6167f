"""other_device_us_per_call.updates: device time a call outside the sweep
kernel ``sq2d_tiled`` (random initial states, thresholds, ``energy_2d``,
copies to and from the host), in us. None without device records."""


def read(view):
    if not view.device or not view.calls:
        return None
    return sum(e - s for _, s, e in view.other(("sq2d_tiled",))) / view.calls
