"""Stream-parallel decode over several devices and ranks (counterpart of
``defl_tpu/parallel``): ``mesh`` lays the batch out, ``shard`` decodes it,
``multihost`` joins a ``torch.distributed`` process group."""
