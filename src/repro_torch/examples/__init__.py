"""Drivers of the port, one module each, run with ``python -m
repro_torch.examples.<name>``: the counterparts of the reference's
``examples/`` (the same flags, defaults, printed lines and checks).

- :mod:`~repro_torch.examples.quickstart` and
  :mod:`~repro_torch.examples.partition_plan`: the planner, the simulator
  and ``LLM.from_plan(kind="sim")``, on the host only;
- :mod:`~repro_torch.examples.serve_pipeline`: a planned stage pipeline
  served with the kernels, every token checked against the tensor
  backend's, then ``stream``;
- :mod:`~repro_torch.examples.train_tiny`: a small qwen3-family model
  trained on the synthetic stream.

The two that run a model run on the GPU unless ``--device cpu`` is given,
and raise where there is none.
"""
