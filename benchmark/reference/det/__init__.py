"""A frozen copy of the port's detection training step, for the plain
reference of the detection training cell: ``afan_torch/models/resnet.py``,
``models/frcnn/*``, ``ops/lowp.py``, ``ops/roi_align.py``, ``ops/nms.py``,
``core/{attack,afn,spectrum,project}.py`` and ``train/detect_loop.py`` as
they stood when the benchmark was written (their docstrings are the
port's). Every import stays inside this folder: the hand-written kernels
are replaced by their plain forms (``pgd_step.py``; ``nms.py``'s
``nms_sorted_mask``, a greedy pass on the host), and the data-parallel and
row-sharding hooks by the one-process identity (``parallel.py``).
``resnet.Conv2d`` and ``resnet.Linear`` gain an ``fp8`` switch (float8
e4m3 operands, per-tensor scale): the control."""
