"""The benchmark of ``distkeras_torch`` on NVIDIA GPUs.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name:

- ``configs/<config>.json``: the model's sizes, its source and its cuts;
- ``traffic/<traffic>.json``: the mix's parameters, read by the module
  its ``kind`` names (``kinds/<kind>.py``);
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: a per-layer metric's reader.

The yardstick is frozen here: the plain f32 references
(``reference/``), the work counts (``work.py``), the peaks
(``device.py``), the trace reduction (``trace.py``) and the comparisons
(``compare.py``). Nothing in this package imports JAX or the JAX
package; ``reference/`` imports nothing of ``distkeras_torch``.
"""
