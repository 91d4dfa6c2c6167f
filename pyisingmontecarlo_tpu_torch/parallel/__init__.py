"""Multi-device paths on ``torch.distributed``: one rank a device, named mesh dimensions.

Counterpart of ``pyisingmontecarlo_tpu/parallel/``: ``mesh`` (meshes and the
process group), ``comm`` (ring shifts and gathers along a mesh dimension),
``replica`` (replica-sharded ``QmcRunner`` and ``QmcIsing``), ``tempering``
(the sharded tempering ladder), ``spatial`` (the torus split into column
slabs) and ``tau`` (the worldline split into tau slabs).
"""
