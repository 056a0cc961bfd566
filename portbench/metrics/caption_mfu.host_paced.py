"""caption_mfu.host_paced: ``caption_mfu`` in the host-paced cells, where it
moves ``caption_images_per_s.host_paced``."""

from portbench.common.readers import same_as

read = same_as("caption_mfu")
