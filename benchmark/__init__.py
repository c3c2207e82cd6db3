"""The benchmark of ``vokselis_torch`` on one CUDA card.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line. Everything a
cell is made of is found by name: its configuration in ``configs/``, its
traffic mix in ``traffic/`` (data, read by the generator its ``kind``
names), the driver its configuration's ``entry`` names in ``drivers/``, and
one reader per metric in ``metrics/``. ``loop.py`` is the frame loop that a
frame cell's driver subclasses with its demo's hooks; each driver and
traffic module also holds the sizes the CPU tests run it at.
``reference/`` is the plain-torch reference that decides ``correct``;
``roofline/`` counts the work a kernel's bound is taken from. Nothing here imports JAX or the JAX package,
and ``reference/`` and ``roofline/`` import nothing of ``vokselis_torch``.
"""
