"""``device_idle_pct.train`` in the detection cells, where it moves
``train_imgs_per_s.det``."""
from benchmark.lib import harness

read = harness.metric_reader("device_idle_pct.train")
