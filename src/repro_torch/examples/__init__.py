"""Runnable examples of the port, twins of the reference's
``examples/quickstart.py``, ``serve_batch.py`` and ``train_tinylm.py``:
``python -m repro_torch.examples.<name> [--device cpu]`` (each defaults to
``--device cuda``; ``main(argv)`` returns what the run checked).  The
low-bit CNN example's twin is :mod:`repro_torch.cnn`."""
