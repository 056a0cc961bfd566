"""decode_kernels_per_batch.host_paced: ``decode_kernels_per_batch`` in the
host-paced cells, where it moves ``caption_images_per_s.host_paced``."""

from portbench.common.readers import same_as

read = same_as("decode_kernels_per_batch")
