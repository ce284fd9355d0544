"""Runnable examples of the port, the twins of the reference's
``examples/``: each runs as ``python -m repro_torch.examples.<name>``, on
the card unless ``--device cpu`` is given, and prints the lines its twin
prints.

  * :mod:`.quickstart` — the paper's scheduler through the session API;
    last, the device backend in float64 and in the float32 near-tie mode.
  * :mod:`.dsms_serve` — continuous queries over a decoding LM stream,
    scheduled by HVLB_CC, then the scheduler service.
  * :mod:`.train_lm` — the data pipeline, AdamW, checkpoints and restart
    on a reduced LM.
"""
