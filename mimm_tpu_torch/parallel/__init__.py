"""Parallel execution over ``torch.distributed`` (mimm_tpu/parallel/
counterpart): data, tensor and sequence parallelism, ZeRO-1 and FSDP
(``mesh``), and GPipe pipeline parallelism of the text tower
(``pipeline``)."""
