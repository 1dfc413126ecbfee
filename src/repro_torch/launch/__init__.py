"""Launch layer of the port (counterpart of ``repro.launch``).

``repro_torch.launch.serve`` holds the batched serving driver
(``serve(...)``, ``ServeResult``, ``python -m repro_torch.launch.serve``),
``repro_torch.launch.train`` the training driver (``run(...)``,
``TrainResult``, ``python -m repro_torch.launch.train``) and
``repro_torch.launch.shapes`` the optimizer factory
(``make_optimizer``).  The package does not re-export them: the
functions share their modules' names, and importing the modules here
would make ``python -m`` import them twice.  Mesh and sharding (``constrain`` is
the identity on one device) come with the multi-card slices.
"""
