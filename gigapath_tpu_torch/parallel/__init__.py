"""The parallel layer (counterpart of ``gigapath_tpu/parallel``): the device
mesh over the ranks of a ``torch.distributed`` group
(:mod:`~gigapath_tpu_torch.parallel.mesh`), the parameter and collective
layout rules (:mod:`~gigapath_tpu_torch.parallel.sharding`), the tensor-parallel
primitives over a ``model`` group (:mod:`~gigapath_tpu_torch.parallel.tensor`)
and the training and evaluation steps over a mesh
(:mod:`~gigapath_tpu_torch.parallel.spmd`).

The caller initialises the process group (its backend, address, world size
and rank); nothing here picks a backend. The sequence-parallel attention
itself lives in :mod:`gigapath_tpu_torch.ops.dilated_attention`
(``seq_group=``), which takes the process group of the mesh's ``seq`` dim.
"""
