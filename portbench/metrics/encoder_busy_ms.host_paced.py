"""encoder_busy_ms.host_paced: ``encoder_busy_ms`` in the host-paced cells,
where it moves ``caption_images_per_s.host_paced``."""

from portbench.common.readers import same_as

read = same_as("encoder_busy_ms")
