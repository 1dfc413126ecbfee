"""Launch layer of the port (counterpart of ``repro.launch``).

``repro_torch.launch.serve`` holds the batched serving driver
(``serve(...)``, ``ServeResult``, the reference's requests per modality
``prefill_batch`` and ``decode_batch``, ``python -m
repro_torch.launch.serve``),
``repro_torch.launch.train`` the training driver (``run(...)``,
``TrainResult``, the reference's batches per modality ``synth_batch``,
``python -m repro_torch.launch.train``); both take a ``mesh`` to run
with DTensor params.  ``repro_torch.launch.mesh`` builds the production
and host ``DeviceMesh``es, ``repro_torch.launch.sharding`` holds the
reference's sharding rules, their DTensor placements and the
activation constrainer, ``repro_torch.launch.shapes`` the optimizer
factory (``make_optimizer``) and the dry run's shapes and sharded
inputs (``build_spec``), and ``python -m repro_torch.launch.dryrun``
the multi-pod dry run on a fake process group.  The mesh names are
exported here, as the reference exports them; the other modules are
not, since their functions share their modules' names and importing
them here would make ``python -m`` import them twice.
"""
from .mesh import (data_axes, data_size, make_host_mesh,
                   make_production_mesh, model_size)

__all__ = ["make_production_mesh", "make_host_mesh", "data_axes",
           "data_size", "model_size"]
