"""caption_images_per_s.host_paced: ``caption_images_per_s`` in the cells
whose pace the host's speed moves (beam search's launches and unpacking),
so that their wider run-to-run spread has a bound of its own."""

from portbench.common.readers import same_as

read = same_as("caption_images_per_s")
