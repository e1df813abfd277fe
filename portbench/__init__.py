"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line last. Each
configuration, traffic mix, limit set and metric reader is a file of its own
under this folder, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``limits/<cell>.json``
and ``metrics/<metric>.py``; a configuration's model family is
``families/<family>.py``.

The yardstick lives here and reads nothing of the program but its entry
points, its kernel calls, AdamW's first moment after the first step
(``harness.first_gradient``) and the profiler's trace: ``work`` (operations and
bytes of each kernel call, the model's product count, the card's peaks),
``data`` (the token batches), ``weights`` (the initial weights), ``reference``
(the plain fp32 layers, loss, clip and AdamW that decide ``correct``, with
``families``, how each family stacks them) and ``check`` (the comparison).
``sets.sh`` makes the runs a bound is set from, ``calibrate.py`` the
readings a limit is set from.
"""
