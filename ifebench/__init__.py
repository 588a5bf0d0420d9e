"""ifebench: the benchmark of ife_tpu_torch on the card.

One run times one cell (a configuration under one traffic mix) for a fixed
window and checks what the timed path produced against a plain reference:

    python3 -m ifebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, entry, check or metric
is a file of its own, found by the name that BENCHMARK.json gives it:
``configs/<config>.json``, ``workloads/<cell>.json``,
``entries/<entry>.py``, ``checks/<check>.py`` and ``metrics/<metric>.py``.
Nothing here imports JAX or the JAX package; the reference
(``reference.py``) imports nothing of the program either.
"""
