"""Launch layer of the port (counterpart of ``repro.launch``).

``repro_torch.launch.serve`` holds the batched serving driver
(``serve(...)``, ``ServeResult``, the reference's requests per modality
``prefill_batch`` and ``decode_batch``, ``python -m
repro_torch.launch.serve``),
``repro_torch.launch.train`` the training driver (``run(...)``,
``TrainResult``, the reference's batches per modality ``synth_batch``,
``python -m repro_torch.launch.train``) and ``repro_torch.launch.shapes``
the optimizer factory (``make_optimizer``; adafactor over the
reference's stacked body groups).  The package does not re-export them: the
functions share their modules' names, and importing the modules here
would make ``python -m`` import them twice.  Mesh and sharding (``constrain`` is
the identity on one device) come with the multi-card slices.
"""
