"""The benchmark of ``stereo_match_traditional_tpu_torch`` on an NVIDIA card.

``BENCHMARK.json`` at the checkout's root names the cells; one run of one
cell is ``python3 cardbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  Each piece is found by its name: ``configs/`` (a
configuration's fields, its plain reference and each timed stage's least
work), ``traffic/`` (a mix's parameters, read by ``traffic.py``),
``metrics/`` (one reader a metric), ``limits/`` (each cell's correctness
limit) and ``reference/`` (the plain PyTorch reference).  The CPU tests are
``python -m pytest cardbench/tests``; ``-m cuda`` runs the card's.
"""
