"""Imported by every ``test_torch_*`` module: torch computes on one
intra-op thread in a test process.

Under pytest-xdist several workers share the machine's cores, and torch's
default of one OpenMP thread a core in each of them oversubscribes the
cores many times over: a small CPU op then waits on the other workers'
threads, a forward and backward of a 300-token dilated attention taking
minutes instead of a fraction of a second. The rank processes of the
distributed tests (``torch_rank_bodies.py``) and of ``dryrun`` take one
thread as well.
"""

import torch

torch.set_num_threads(1)
