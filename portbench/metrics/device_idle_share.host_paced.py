"""device_idle_share.host_paced: ``device_idle_share.caption`` in the host-
paced cells, where it moves ``caption_images_per_s.host_paced``."""

from portbench.common.readers import same_as

read = same_as("device_idle_share.caption")
