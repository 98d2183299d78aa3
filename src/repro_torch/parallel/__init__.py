"""Sharded dispatch of a sweep's buckets over a list of devices.

``sharding`` holds the row arithmetic (units, power-of-two superchunks,
padding to the device count, shards) and the device list; the reference's
``shard_map`` wrapper has no counterpart, as each shard is its own launch
on its own device's streams (``repro_torch.core.batch``).
"""
