"""The port's communication layer (port of ``vault_tpu/parallel/``):
process groups and the ("data", "model") mesh (``mesh``), the
explicit-collective data-parallel step (``shard_map_step``), ZeRO-1 moment
sharding (``zero``), the Megatron sharding rules (``sharding``) and
operators (``tensor_parallel``), the 2-stage pipeline (``pipeline``), the
multi-process harness (``multihost``) and the multi-rank dry run
(``dryrun``)."""
