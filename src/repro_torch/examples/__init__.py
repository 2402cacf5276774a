"""The LM track's examples as entry points of the port, the counterparts of
the reference's ``examples/`` scripts: ``python -m
repro_torch.examples.<name>`` with ``quickstart``, ``lm_compression``,
``serve_demo`` or ``train_lm_100m``. Each runs on CUDA unless ``--device
cpu`` is given, and its ``main(argv)`` returns what it printed, for a
caller that checks it."""
