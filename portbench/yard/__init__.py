"""The yardstick: traffic generation, seeded weights, the plain references'
shared parts, trace reduction, peaks and the comparisons that decide
``correct``. Nothing here imports ``tgm_tpu_torch`` except ``window.py`` and
``linkpred.py``, which drive it, and ``evalcell.py`` through ``window.py``."""
