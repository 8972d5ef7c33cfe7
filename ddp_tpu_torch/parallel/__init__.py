"""Data-parallel training over ``torch.distributed``: the process group and
its device mesh (``mesh.py``), and what a train step computes over the
global batch (``global_batch.py``)."""
