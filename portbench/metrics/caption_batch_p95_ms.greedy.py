"""caption_batch_p95_ms.greedy: ``caption_batch_p95_ms`` read in the traced
run of the greedy cells, where it moves ``caption_images_per_s``.  Per layer,
not end to end: the same seeds on two H100 machines spread it 0.71 % and
4.50 % from run to run, more apart than one bound can hold."""

from portbench.common.readers import same_as

read = same_as("caption_batch_p95_ms.host_paced")
