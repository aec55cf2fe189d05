"""Parallelism on the port (``torch.distributed``): process groups and
data sharding (``mesh``), FSDP (``fsdp``), tensor parallelism (``tp``),
pipeline parallelism (``pp``), the sequence-parallel attention ring
(``ring``) and the multi-process dryrun (``multihost``)."""
