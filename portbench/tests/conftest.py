"""Tiny sizes of the cells whose files were added after ``pb_tiny.py``, for
the CPU tests that copy the benchmark at tiny sizes (``pb_tiny.tiny_copy``)."""

import pb_tiny

pb_tiny.TINY_CONFIGS.update({"tfim_sq_256": {"side": 8}})
pb_tiny.TINY_PARAMS.update({
    "tfim2d256.tiled": {"timesteps": 5, "num_experiments": 3, "beta": 2.0, "check_replicas": 2},
})
