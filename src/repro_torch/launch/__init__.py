"""Launch layer of the port (counterpart of ``repro.launch``).

``repro_torch.launch.serve`` holds the batched serving driver:
``serve(...)``, ``ServeResult`` and ``main()`` (``python -m
repro_torch.launch.serve``).  The package does not re-export them: the
function shares its module's name, and importing the module here would
make ``python -m`` import it twice.  Mesh and sharding (``constrain`` is
the identity on one device) come with the multi-card slices.
"""
