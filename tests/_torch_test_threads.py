"""Caps torch's CPU thread pool at one thread in the port's test processes.

pytest-xdist runs several workers on one machine; each torch process
otherwise opens an intra-op pool as wide as the machine, and the workers
then contend for the cores (the port's tests run several times slower).
Every `tests/test_torch_*.py` imports this module first, and so does each
rank spawned by `tests/_torch_dist_worker.py`; the first import sets the
cap for the process.
"""

import torch

torch.set_num_threads(1)
